"""device_idle.day: the share of the traced day in which no kernel,
copy or set ran on the card, in %."""

from portbench.tracing import idle_percent


def read(ctx):
    return idle_percent(ctx.trace)

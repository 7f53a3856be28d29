"""mfu.rescore: a whole request's share of the card's peak, in %: the
least time of one filtered scan over the mean wall of a request in
the window."""

from portbench import cost


def read(ctx):
    least = cost.least_seconds(ctx.device_name, ctx.cost["request_bytes"],
                               ctx.cost["request_flops"])
    wall = ctx.spans.mean("step")
    if least is None or not wall:
        return None
    return 100.0 * least / wall

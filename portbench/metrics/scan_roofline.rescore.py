"""scan_roofline.rescore: the filtered scan's share of its roofline,
in %: the least bytes of one filtered scan of the day
(`cost.filtered_scan`) over the card's peak bandwidth, divided by the
device time of every kernel of a request over the traced requests."""

from portbench import cost


def read(ctx):
    if ctx.trace is None or not ctx.trace.steps:
        return None
    secs = sum(s for _, s in ctx.trace.kernels.values()) / ctx.trace.steps
    least = cost.least_seconds(ctx.device_name, ctx.cost["request_bytes"])
    if least is None or secs <= 0:
        return None
    return 100.0 * least / secs

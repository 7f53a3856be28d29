"""rescore.filter_ms: mean wall of a request's filter stage over the
window: the verdicts merged into the day's filter
(`HostFilter.merged`) and its tables put on the card, host clock."""


def read(ctx):
    v = ctx.spans.mean("filter")
    return None if v is None else v * 1e3

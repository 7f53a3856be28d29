"""day.score_ms: mean wall of a day's scoring and selection over the
days of the window (`select_suspicious_events`, the bottom-M read
back), host clock."""


def read(ctx):
    v = ctx.spans.mean("score")
    return None if v is None else v * 1e3

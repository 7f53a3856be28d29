"""mfu.day: the whole day's share of the card's peak, in %: the least
time of a day's work (its block steps and its scoring, bytes from
shapes over the peak bandwidth or operations over the float32 peak,
whichever is larger) over the mean wall of a day in the window."""

from portbench import cost


def read(ctx):
    least = cost.least_seconds(ctx.device_name, ctx.cost["day_bytes"],
                               ctx.cost["day_flops"])
    wall = ctx.spans.mean("step")
    if least is None or not wall:
        return None
    return 100.0 * least / wall

"""gibbs_step_roofline.day: the Gibbs block step's share of its
roofline over the traced day, in %.

The least bytes of all the day's block steps (`cost.gibbs_fit`: ids,
old and new topics, the touched count rows, without the random
numbers) over the card's peak bandwidth, divided by the device time of
every kernel of the step. A kernel belongs to the step when the traced
day launched it at least once a block step: the step's own kernels
(the noise draw's and K1's) launch exactly that often, the fit's other
work (initialisation, likelihoods, estimates) far less."""

from portbench import cost


def read(ctx):
    if ctx.trace is None:
        return None
    steps = ctx.cost["steps"]
    secs = sum(s for n, s in ctx.trace.kernels.values() if n >= steps)
    least = cost.least_seconds(ctx.device_name,
                               ctx.cost["step_bytes"] * steps)
    if least is None or secs <= 0:
        return None
    return 100.0 * least / secs

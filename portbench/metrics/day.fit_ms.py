"""day.fit_ms: mean wall of a day's fit over the days of the window
(`fit_engine` through `GibbsLDA.fit`), host clock; the fit returns its
estimates on the host, so the span ends when the card is done."""


def read(ctx):
    v = ctx.spans.mean("fit")
    return None if v is None else v * 1e3

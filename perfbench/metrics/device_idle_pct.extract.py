"""Share of the traced extractor window in which no kernel, copy or fill
ran on the card (the union of the profiler's device intervals)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or ctx.get("kind") != "extract":
        return None
    return trace.idle_pct()

"""Share of the traced SLAM window in which no kernel, copy or fill ran on
the card (the union of the profiler's device intervals)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or ctx.get("kind") != "slam":
        return None
    return trace.idle_pct()

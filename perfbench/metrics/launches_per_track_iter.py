"""Kernel launches the host issued inside the harness's spans around
`FrontEnd.track`, from the profiler's launch records, per tracking
iteration of the traced window."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or ctx.get("kind") != "slam" or not ctx["track_iters"]:
        return None
    n = trace.launches_in(ctx["spans"], "track")
    return n / ctx["track_iters"] if n else None

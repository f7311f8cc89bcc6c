"""Share of its roofline the blend forward kernel reaches in the traced
window: the sum over its calls of the least time the card could take
(harness/counts.py) over the profiler's device time of `blend::fwd_kernel`."""


def read(ctx):
    trace, blend = ctx.get("trace"), ctx.get("blend")
    if trace is None or not blend or not blend["fwd"]["calls"]:
        return None
    t = trace.kernel_s("blend::fwd_kernel")
    return 100.0 * blend["fwd"]["bound_s"] / t if t > 0 else None

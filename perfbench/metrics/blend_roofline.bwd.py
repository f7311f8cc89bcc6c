"""Share of its roofline the blend backward (the rows kernel and the
per-Gaussian reduce together) reaches in the traced window: the sum over
its calls of the least time the card could take (harness/counts.py) over
the profiler's device time of `blend::bwd_kernel` and
`blend::reduce_kernel` (the kernels' namespace keeps PyTorch's own
`reduce_kernel` out)."""


def read(ctx):
    trace, blend = ctx.get("trace"), ctx.get("blend")
    if trace is None or not blend or not blend["bwd"]["calls"]:
        return None
    t = trace.kernel_s("blend::bwd_kernel", "blend::reduce_kernel")
    return 100.0 * blend["bwd"]["bound_s"] / t if t > 0 else None

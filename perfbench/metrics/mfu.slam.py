"""Share of the card's float32 peak the whole SLAM step reaches in the
traced window: the operations counted for the window (the extractor's per
extraction, the blend kernels' per recorded call) over the window's
length times the peak. Work outside those (projection, binning, losses,
optimizers) is not counted, so this is a lower bound."""

from perfbench.harness.counts import PEAK_F32_FLOPS


def read(ctx):
    trace, blend = ctx.get("trace"), ctx.get("blend")
    if trace is None or ctx.get("kind") != "slam" or not blend:
        return None
    flops = ctx["extract_flops"] * ctx["extractions"] + blend["fwd"]["flops"] + blend["bwd"]["flops"]
    return 100.0 * flops / (trace.window_s * PEAK_F32_FLOPS)

"""Share of the card's float32 peak the extractor reaches in the traced
window: its operations per frame from the published shapes
(harness/counts.py `extractor_flops`) times the frames, over the window's
length times the peak."""

from perfbench.harness.counts import PEAK_F32_FLOPS


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or ctx.get("kind") != "extract":
        return None
    return 100.0 * ctx["extract_flops"] * ctx["frames"] / (trace.window_s * PEAK_F32_FLOPS)

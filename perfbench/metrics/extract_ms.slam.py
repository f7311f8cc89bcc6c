"""Milliseconds per keyframe extraction inside the SLAM window: the change
in `BackEnd.lang_extract_s` (synchronized) over the keyframes whose
supervision the window computed."""


def read(ctx):
    if ctx.get("kind") != "slam" or not ctx["extractions"]:
        return None
    return 1e3 * ctx["extract_s"] / ctx["extractions"]

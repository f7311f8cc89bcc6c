"""Milliseconds of the SLAM loop's `data` phase (frame decode, upload and
gradient mask, or the wait for the prefetch threads) per frame of the
window, from the program's synchronized phase times."""


def read(ctx):
    if ctx.get("kind") != "slam" or not ctx["frames"]:
        return None
    return 1e3 * ctx["phase_s"]["data"] / ctx["frames"]

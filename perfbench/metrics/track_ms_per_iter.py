"""Milliseconds of the SLAM loop's `track` phase per tracking iteration of
the window (`FrontEnd.track_iters`), from the program's synchronized
phase times."""


def read(ctx):
    if ctx.get("kind") != "slam" or not ctx["track_iters"]:
        return None
    return 1e3 * ctx["phase_s"]["track"] / ctx["track_iters"]

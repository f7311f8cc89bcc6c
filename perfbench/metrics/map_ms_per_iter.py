"""Milliseconds of the SLAM loop's `map` phase, less the language
extraction inside it (`BackEnd.lang_extract_s`), per mapping iteration
of the window (`BackEnd.iteration_count`)."""


def read(ctx):
    if ctx.get("kind") != "slam" or not ctx["map_iters"]:
        return None
    return 1e3 * (ctx["phase_s"]["map"] - ctx["extract_s"]) / ctx["map_iters"]

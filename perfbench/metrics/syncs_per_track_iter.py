"""Host syncs per tracking iteration of the traced window: the program's
sync spans (`sync.*`) below its `track.iter` spans, over those iterations
(harness/program_spans.py)."""

from perfbench.harness import program_spans


def read(ctx):
    if ctx.get("kind") != "slam":
        return None
    got = program_spans.per_iteration(ctx, "track.iter")
    if got is None:
        return None
    win, its = got
    return sum(len(win.syncs_below(s)) for s in its) / len(its)

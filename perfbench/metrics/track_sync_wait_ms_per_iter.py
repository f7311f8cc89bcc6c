"""Milliseconds per tracking iteration the host waits in syncs: the summed
length of the program's sync spans below its `track.iter` spans in the
traced window, over those iterations (harness/program_spans.py)."""

from perfbench.harness import program_spans


def read(ctx):
    if ctx.get("kind") != "slam":
        return None
    got = program_spans.per_iteration(ctx, "track.iter")
    if got is None:
        return None
    win, its = got
    return sum(program_spans.ms(y) for s in its for y in win.syncs_below(s)) / len(its)

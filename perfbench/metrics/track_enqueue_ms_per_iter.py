"""Milliseconds per tracking iteration the host spends issuing work: the
program's `track.iter` spans in the traced window, less the sync spans
below them, over those iterations (harness/program_spans.py)."""

from perfbench.harness import program_spans


def read(ctx):
    if ctx.get("kind") != "slam":
        return None
    got = program_spans.per_iteration(ctx, "track.iter")
    if got is None:
        return None
    win, its = got
    return sum(program_spans.ms(s) - sum(program_spans.ms(y) for y in win.syncs_below(s))
               for s in its) / len(its)

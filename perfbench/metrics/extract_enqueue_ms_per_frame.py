"""Milliseconds per frame the host spends issuing the extractor's work:
the program's `extract.frame` spans (`LangFeatureExtractor.encode_frame`)
in the traced window, less any sync span below them, over those frames
(harness/program_spans.py)."""

from perfbench.harness import program_spans


def read(ctx):
    if ctx.get("kind") != "extract":
        return None
    got = program_spans.per_iteration(ctx, "extract.frame")
    if got is None:
        return None
    win, its = got
    return sum(program_spans.ms(s) - sum(program_spans.ms(y) for y in win.syncs_below(s))
               for s in its) / len(its)

"""Host syncs of the whole SLAM step per frame of the traced window: every
sync span (`sync.*`) the program recorded inside the window (tracking,
keyframe insertion, mapping and its extractions, the loop's phase fences)
over the window's frames (harness/program_spans.py)."""

from perfbench.harness import program_spans


def read(ctx):
    if ctx.get("kind") != "slam" or not ctx["frames"]:
        return None
    win = program_spans.window(ctx)
    if win is None or not win.spans:
        return None
    return len(win.syncs()) / ctx["frames"]

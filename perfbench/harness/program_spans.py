"""The program's own spans in a traced run's window.

The port records its spans in `online_lang_splatting_tpu_torch.utils.
profiling.RECORDER` while a `torch.profiler` session records, which the
traced run's `tracer.Profile` is, on `time.time_ns()`, the clock of the
window's ends `ctx["trace"].t0` / `.t1`. A span named `sync.<site>` is one
host sync of the program. A port without the recorder gives nothing to
read, and the readers then leave their metric out."""

from __future__ import annotations

from collections import defaultdict

SYNC = "sync."


class Window:
    """The spans that opened and closed inside the window, with each
    span's sync spans below it (children, grandchildren, ...)."""

    def __init__(self, spans: list):
        self.spans = spans
        self._children: dict = defaultdict(list)
        for s in spans:
            if s.parent is not None:
                self._children[s.parent].append(s)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def syncs(self) -> list:
        return [s for s in self.spans if s.name.startswith(SYNC)]

    def syncs_below(self, span) -> list:
        out, todo = [], list(self._children[span.id])
        while todo:
            s = todo.pop()
            if s.name.startswith(SYNC):
                out.append(s)
            todo.extend(self._children[s.id])
        return out


def ms(span) -> float:
    return (span.t1_ns - span.t0_ns) * 1e-6


def window(ctx: dict) -> Window | None:
    """The window's program spans; None without a trace or a recorder."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    try:
        from online_lang_splatting_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorder = getattr(profiling, "RECORDER", None)
    if recorder is None:
        return None
    return Window([s for s in recorder.spans() if trace.t0 <= s.t0_ns and s.t1_ns <= trace.t1])


def per_iteration(ctx: dict, name: str):
    """(window, the spans called `name`), or None when the window has
    none of them."""
    win = window(ctx)
    if win is None:
        return None
    its = win.named(name)
    return (win, its) if its else None

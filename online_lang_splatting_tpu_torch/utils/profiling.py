"""Profiling and timing helpers (port of utils/profiling.py).

`trace(log_dir)` records a `torch.profiler` trace of the CPU and, where
present, the card, written for TensorBoard / Perfetto under `log_dir`.
`span(name)` is the program's own span: while a `torch.profiler` session
records (and only then) it appends to `RECORDER` its name, its start and
end on `time.time_ns()` (the clock the profiler's events carry), its
parent span, its thread and the frame index `set_frame` last gave on that
thread. Inside `trace` it also opens a `record_function` of the same name,
so the trace shows it beside the kernels; under any other session it does
not, since an open `record_function` range made the profiler's per-launch
cost grow on the card (traced tracking iterations 11-28 % slower on an
H100, PERF.md §6). A span named `sync.<site>` wraps one host sync: its count is
the number of syncs, its length the host's wait. No span synchronizes.
`Timers` sums wall-clock spans; a span with a fence waits for the work
queued on the fence's device (`torch.cuda.synchronize`) before it stops
its clock, so asynchronous launches are charged to the span that queued
them. The report keeps the JAX package's text format. `graph_ms` times
launches on the card with no host enqueue in the measurement.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SYNC = "sync."  # the name prefix of a span around one host sync


class Span(NamedTuple):
    id: int
    parent: Optional[int]  # the span open on the same thread when it opened
    name: str
    t0_ns: int             # time.time_ns()
    t1_ns: int
    thread: int            # threading.get_ident()
    frame: Optional[int]   # the frame index `set_frame` gave the thread


class Recorder:
    """The spans closed while a `torch.profiler` session recorded, at most
    `cap` of them; `dropped` counts those past the cap. Spans close on any
    thread (the threaded SLAM's frontend and backend)."""

    def __init__(self, cap: int = 1 << 20):
        self.cap = cap
        self.dropped = 0
        self.annotate = False  # spans open a record_function (inside `trace`)
        self._spans: list = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, span: Span):
        with self._lock:
            if len(self._spans) < self.cap:
                self._spans.append(span)
            else:
                self.dropped += 1

    def spans(self) -> list:
        """The recorded spans, in the order they closed."""
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()
            self.dropped = 0


# One per process, as the profiler session it follows is: the benchmark's
# readers and a trace's owner find it without a handle from the program.
RECORDER = Recorder()


def set_frame(idx: Optional[int]):
    """The frame index the calling thread's next spans carry."""
    RECORDER._local.frame = idx


class _Open:
    """One span being recorded."""

    __slots__ = ("name", "fn", "id", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = RECORDER._stack()
        self.id = next(RECORDER._ids)
        stack.append(self.id)
        self.fn = _autograd_profiler.record_function(self.name) if RECORDER.annotate else None
        if self.fn is not None:
            self.fn.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        stack = RECORDER._stack()
        stack.pop()
        RECORDER._add(Span(self.id, stack[-1] if stack else None, self.name, self.t0, t1,
                           threading.get_ident(), getattr(RECORDER._local, "frame", None)))
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` (see the module's docstring);
    with no profiler session it is a shared no-op. A session is seen from
    every thread (torch sets this flag as a session starts and stops;
    `torch.autograd._profiler_enabled()` sees only the thread that started
    it, and the threaded SLAM records from two)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace viewable in TensorBoard/Perfetto,
    with the program's spans in it."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        RECORDER.annotate = True
        try:
            yield
        finally:
            RECORDER.annotate = False


def graph_ms(fn, runs: int, repeats: int = 3) -> float:
    """Milliseconds per call of `runs` calls of `fn` captured into one CUDA
    graph and replayed between two CUDA events (median of `repeats`), after
    a warm-up: the card's time for the launches back to back, with no host
    enqueue in it (a short kernel launched through ctypes costs the host
    more than the card). `fn` allocates nothing and does not synchronize."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / runs)
    del graph
    return sorted(times)[len(times) // 2]


def _sync(fence):
    """Wait for the queued work on the devices of `fence` (a tensor, a
    device, or a nested list / tuple / dict of tensors)."""
    if isinstance(fence, dict):
        fence = list(fence.values())
    if isinstance(fence, (list, tuple)):
        for f in fence:
            _sync(f)
        return
    device = fence.device if isinstance(fence, torch.Tensor) else torch.device(fence)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timers:
    """Wall-clock spans with device fencing.

    A span fences on a provided tensor (or device) so asynchronous
    launches are not charged to a later span. Usage:

        timers = Timers()
        with timers.span("tracking", fence=out.color):
            ...
        print(timers.report())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, fence=None):
        t0 = time.perf_counter()
        yield
        if fence is not None:
            _sync(fence)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(
                f"{name}: total {tot:.3f}s over {n} calls "
                f"({tot / max(n, 1) * 1000:.1f} ms avg)"
            )
        return "\n".join(lines)

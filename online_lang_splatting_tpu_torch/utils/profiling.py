"""Profiling and timing helpers (port of utils/profiling.py).

`trace(log_dir)` records a `torch.profiler` trace of the CPU and, where
present, the card, written for TensorBoard / Perfetto under `log_dir`.
`Timers` sums wall-clock spans; a span with a fence waits for the work
queued on the fence's device (`torch.cuda.synchronize`) before it stops
its clock, so asynchronous launches are charged to the span that queued
them. The report keeps the JAX package's text format. `graph_ms` times
launches on the card with no host enqueue in the measurement.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace viewable in TensorBoard/Perfetto."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


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

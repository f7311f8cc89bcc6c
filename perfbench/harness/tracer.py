"""The traced run: `torch.profiler` over the window (device activity and
the host's launch calls), the harness's own spans around the program's
layers, and the reduction of both to busy time, idle gaps, launches per
span and device time per kernel name."""

from __future__ import annotations

import time
from collections import defaultdict


class Spans:
    """Host-clock spans (ns since the epoch, the profiler's clock) recorded
    by wrappers the harness puts around the program's methods."""

    def __init__(self, sync=None):
        self.spans: list = []          # (start_ns, end_ns, name)
        self.sync = sync               # waits for the device before a span closes

    def wrap(self, obj, attr: str, name: str):
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return inner(*args, **kwargs)
            finally:
                if self.sync is not None:
                    self.sync()
                self.spans.append((t0, time.time_ns(), name))

        setattr(obj, attr, wrapped)

    def label(self, t_ns: int) -> str:
        """The innermost span open at t_ns, else "outside"."""
        best = None
        for s, e, n in self.spans:
            if s <= t_ns <= e and (best is None or s >= best[0]):
                best = (s, e, n)
        return best[2] if best else "outside"


class Profile:
    """Device activity and launch calls between `start` and `stop`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = None

    def start(self):
        self._prof.start()
        self.t0 = time.time_ns()

    def stop(self, sync):
        sync()
        self.t1 = time.time_ns()
        self._prof.stop()

    def reduce(self) -> "Trace":
        from torch.autograd import DeviceType

        device, launches = [], []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                device.append((s, s + e.duration_ns(), name))
            elif "LaunchKernel" in name:
                launches.append(e.start_ns())
        self._prof = None
        return Trace(self.t0, self.t1, device, launches)


class Trace:
    def __init__(self, t0: int, t1: int, device: list, launches: list):
        self.t0, self.t1 = t0, t1
        # Activity clipped to the window.
        self.device = [(max(s, t0), min(e, t1), n) for s, e, n in device if e > t0 and s < t1]
        self.launches = sorted(launches)
        self.window_s = (t1 - t0) * 1e-9
        self.merged = self._merge()
        self.busy_s = sum(e - s for s, e in self.merged) * 1e-9

    def _merge(self):
        out = []
        for s, e, _ in sorted(self.device):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def gaps(self, spans: Spans, top: int = 10) -> list:
        """The longest idle stretches of the device, named by the harness
        span open at their middle: [[name, seconds], ...]."""
        edges = [self.t0] + [v for s, e in self.merged for v in (s, e)] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        return [[spans.label(s + d // 2), d * 1e-9] for d, s in gaps]

    def device_ops(self, top: int = 10) -> list:
        tot: dict = defaultdict(int)
        for s, e, n in self.device:
            tot[n[:200]] += e - s
        return [[n, v * 1e-9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def kernel_s(self, *needles: str) -> float:
        """Device seconds of activity whose name holds one of `needles`."""
        return sum(e - s for s, e, n in self.device if any(k in n for k in needles)) * 1e-9

    def launches_in(self, spans: Spans, name: str) -> int:
        import bisect

        n = 0
        for s, e, k in spans.spans:
            if k == name:
                n += bisect.bisect_right(self.launches, e) - bisect.bisect_left(self.launches, s)
        return n

"""Decoding frames and building Cameras ahead of the SLAM loop (port of
slam/prefetch.py).

`PrefetchDataset` decodes the next frames on a small thread pool; both
decoders release the interpreter lock (ctypes calls, zlib), so decoding
overlaps the current frame's tracking. `CameraPrefetcher` builds each
`Camera` (the upload to the run's device and the gradient mask) on one
worker thread. Work made there goes to that thread's current stream, the
device's default stream, which every thread of the port shares, and the
copies are blocking, so a Camera is complete when its future resolves.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

from ..utils.profiling import set_frame


class _Lookahead:
    """Futures for the next `lookahead` indices, computed by `fn` on a
    pool; `get(i)` schedules i+1..i+lookahead and returns `fn(i)`."""

    def __init__(self, fn, n: int, lookahead: int, workers: int, name: str):
        self._fn = fn
        self._n = n
        self._lookahead = lookahead
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix=name)
        self._lock = threading.Lock()
        self._pending: "OrderedDict[int, Future]" = OrderedDict()
        self._closed = False

    def _schedule(self, idx: int):
        if self._closed:
            return
        if 0 <= idx < self._n and idx not in self._pending:
            self._pending[idx] = self._pool.submit(self._fn, idx)
            # Bound memory: drop the oldest entries nobody consumed.
            while len(self._pending) > 2 * self._lookahead + 2:
                old = next(iter(self._pending))
                if old >= idx:
                    break
                self._pending.pop(old)

    def get(self, idx: int):
        with self._lock:
            fut = self._pending.pop(idx, None)
            for ahead in range(1, self._lookahead + 1):
                self._schedule(idx + ahead)
        return self._fn(idx) if fut is None else fut.result()

    def close(self):
        """Stop the workers (waiting for the one running) and drop what was
        prefetched; later `get` calls compute synchronously."""
        with self._lock:
            self._closed = True
            self._pending.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)


class PrefetchDataset:
    """A dataset whose sequential reads hit frames decoded ahead. Other
    attributes (fx, poses, ...) pass through to the wrapped dataset."""

    def __init__(self, dataset, lookahead: int = 3, workers: int = 2):
        self._dataset = dataset
        self._ahead = _Lookahead(dataset.__getitem__, len(dataset), lookahead, workers,
                                 "prefetch")

    def __len__(self):
        return len(self._dataset)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._dataset, name)

    def __getitem__(self, idx: int):
        return self._ahead.get(idx)

    def close(self):
        self._ahead.close()


class CameraPrefetcher:
    """Builds the Cameras of the next frames on one worker thread."""

    def __init__(self, dataset, config, device, lookahead: int = 2):
        self._dataset = dataset
        self._config = config
        self._device = device
        self._ahead = _Lookahead(self._build, len(dataset), lookahead, 1, "cam-prefetch")

    def _build(self, idx: int):
        from .camera import Camera

        set_frame(idx)
        cam = Camera.from_dataset(self._dataset, idx, self._device)
        cam.compute_grad_mask(self._config)
        return cam

    def get(self, idx: int):
        return self._ahead.get(idx)

    def close(self):
        self._ahead.close()

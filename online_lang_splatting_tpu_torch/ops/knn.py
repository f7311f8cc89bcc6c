"""k-nearest-neighbour mean squared distance (port of ops/knn.py).

Exact blocked brute force in plain PyTorch: a (block, N) squared-distance
tile from one matmul, then k-smallest via `topk`. Same expansion
(|q|² - 2 q·p + |p|²) as the JAX reference, so values agree to float
rounding. Not a Pallas kernel in the reference, so no hand-written kernel.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span


def knn_mean_sq_dist(points: torch.Tensor, valid: torch.Tensor | None = None,
                     k: int = 3, block: int = 1024) -> torch.Tensor:
    """Mean squared distance to the k nearest valid neighbours (excluding
    self). Invalid points neither query nor serve; their result is 0."""
    n = points.shape[0]
    v = torch.ones(n, dtype=torch.bool, device=points.device) if valid is None else valid
    sq = torch.sum(points * points, dim=-1)
    with span("sync.knn.inf"):
        big = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    cols = torch.arange(n, device=points.device)
    out = torch.zeros(n, dtype=points.dtype, device=points.device)
    kk = min(k, n)
    for i0 in range(0, n, block):
        q = points[i0:i0 + block]
        d2 = sq[i0:i0 + block, None] - 2.0 * (q @ points.T) + sq[None, :]
        d2 = torch.clamp(d2, min=0.0)
        rows = torch.arange(i0, i0 + q.shape[0], device=points.device)
        d2 = torch.where(v[None, :] & (cols[None, :] != rows[:, None]), d2, big)
        m = torch.topk(d2, kk, dim=1, largest=False).values
        acc = torch.where(torch.isfinite(m), m, torch.zeros_like(m)).sum(dim=1)
        out[i0:i0 + q.shape[0]] = acc / k
    return torch.where(v, out, torch.zeros_like(out))

"""Approximate Earth Mover's Distance (approxmatch; port of ops/emd.py).

The PointNet-style auction matching of the reference's 3D semantic
evaluation: ten rounds of soft assignment at the temperature schedule
level = -4^j for j = 7 .. -1, then a last round at level 0, keeping each
point's remaining mass (multiplicities n/m), then cost = sum of match *
squared distance. Every round is (N, M) matrix work in plain PyTorch, as
the JAX package runs it in plain XLA.

Gradients flow through the cost with the match held fixed: the match is
computed under `torch.no_grad()`.
"""

from __future__ import annotations

import torch

# -4^7 .. -4^-1, then 0: exact in float32.
LEVELS = tuple(-(4.0 ** j) for j in range(7, -2, -1)) + (0.0,)


def _pairwise_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, -1)[:, None] - 2.0 * x @ y.T + torch.sum(y * y, -1)[None, :]


@torch.no_grad()
def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """xyz1 (N, 3), xyz2 (M, 3) -> match (M, N) transport plan."""
    n, m = xyz1.shape[0], xyz2.shape[0]
    f32 = dict(dtype=torch.float32, device=xyz1.device)
    d2 = _pairwise_sq(xyz1, xyz2)  # (N, M)
    multi_l = float(max(m // n, 1) if m > n else 1)
    multi_r = float(max(n // m, 1) if n > m else 1)
    match = torch.zeros((n, m), **f32)  # transposed at the end
    remain_l = torch.full((n,), multi_l, **f32)
    remain_r = torch.full((m,), multi_r, **f32)
    for level in LEVELS:
        k = torch.exp(level * d2)
        # 1) provisional left ratios
        ratio_l = remain_l / (1e-9 + k @ remain_r)
        # 2) right consumption
        sumr = (k.T @ ratio_l) * remain_r
        ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        # 3) transported mass
        upd = k * ratio_l[:, None] * ratio_r[None, :]
        match += upd
        remain_l = torch.clamp(remain_l - torch.sum(upd, dim=1), min=0.0)
    return match.T


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """Sum of match * squared distance (scalar)."""
    return torch.sum(match.T * _pairwise_sq(xyz1, xyz2))


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """EMD with gradients through the cost only (the match is a constant in
    the backward, as in the reference's CUDA extension)."""
    return match_cost(xyz1, xyz2, approx_match(xyz1.detach(), xyz2.detach()))

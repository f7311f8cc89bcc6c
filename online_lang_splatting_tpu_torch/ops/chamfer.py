"""Chamfer distance between point clouds, blocked (port of ops/chamfer.py):
the symmetric mean nearest-neighbour distance, for clouds of unequal size.

Squared distances use the JAX package's expression |q|^2 - 2 q.y + |y|^2
(a float32 matrix product, TF32 off on the card), a block of query rows at
a time; the reference points are taken in column chunks so that one block's
distance matrix stays under `MAX_ELEMS` floats. The minimum is exact, so
the chunking does not change the result.
"""

from __future__ import annotations

import torch

MAX_ELEMS = 1 << 26


@torch.no_grad()
def nn_dist(x: torch.Tensor, y: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """For each point in x (N, 3): distance to the nearest point in y (M, 3)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    ysq = torch.sum(y * y, dim=-1)
    cols = max(MAX_ELEMS // block, 1)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], block):
        q = x[i: i + block]
        qsq = torch.sum(q * q, dim=-1)[:, None]
        best = None
        for j in range(0, y.shape[0], cols):
            d2 = qsq - 2.0 * q @ y[j: j + cols].T + ysq[None, j: j + cols]
            m = torch.amin(d2, dim=1)
            best = m if best is None else torch.minimum(best, m)
        out[i: i + block] = torch.sqrt(torch.clamp(best, min=0.0))
    return out


def chamfer_distance(x, y, block: int = 2048) -> dict:
    """Symmetric Chamfer: mean NN distance both ways, plus each direction."""
    completeness = float(torch.mean(nn_dist(x, y, block=block)))
    accuracy = float(torch.mean(nn_dist(y, x, block=block)))
    return {"chamfer": 0.5 * (completeness + accuracy),
            "x_to_y": completeness, "y_to_x": accuracy}

"""SO(3)/SE(3) exponential maps and pose retraction (port of ops/lie.py).

Left-multiplicative SE(3) updates `T_new = Exp(tau) @ T_w2c` with
tau = [rho(3), theta(3)]. The small-angle branches switch at angle < 1e-3
and are written in the squared norm, so values and autograd gradients stay
finite at the identity, exactly as in the JAX reference.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span


def skew(v: torch.Tensor) -> torch.Tensor:
    """[v]_x with [v]_x @ u = v × u. v: (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def _sincs(theta: torch.Tensor):
    """(sin a / a, (1-cos a)/a², (a-sin a)/a³) of a = ‖theta‖ with Taylor
    branches below a = 1e-3 (see ops/lie.py:_sincs in the JAX package)."""
    sq = torch.sum(theta * theta)
    small = sq < 1e-6
    a2 = torch.where(small, torch.ones_like(sq), sq)
    a = torch.sqrt(a2)
    sin_a, cos_a = torch.sin(a), torch.cos(a)
    c1 = torch.where(small, 1.0 - sq / 6.0, sin_a / a)
    c2 = torch.where(small, 0.5 - sq / 24.0, (1.0 - cos_a) / a2)
    c3 = torch.where(small, 1.0 / 6.0 - sq / 120.0, (a - sin_a) / (a2 * a))
    return c1, c2, c3


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: theta (3,) -> R (3, 3)."""
    w = skew(theta)
    w2 = w @ w
    c1, c2, _ = _sincs(theta)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye + c1 * w + c2 * w2


def so3_left_jacobian(theta: torch.Tensor) -> torch.Tensor:
    w = skew(theta)
    w2 = w @ w
    _, c2, c3 = _sincs(theta)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye + c2 * w + c3 * w2


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """tau = [rho(3), theta(3)] -> homogeneous (4, 4) transform."""
    rho, theta = tau[:3], tau[3:]
    r = so3_exp(theta)
    t = so3_left_jacobian(theta) @ rho
    top = torch.cat([r, t[:, None]], dim=1)
    with span("sync.lie.row"):  # an upload, which waits for the device
        bottom = torch.tensor(
            [[0.0, 0.0, 0.0, 1.0]], dtype=tau.dtype, device=tau.device
        )
    return torch.cat([top, bottom], dim=0)


def rt_to_mat4(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> homogeneous 4x4."""
    top = torch.cat([r, t[:, None]], dim=1)
    with span("sync.lie.row"):
        bottom = torch.tensor(
            [[0.0, 0.0, 0.0, 1.0]], dtype=r.dtype, device=r.device
        )
    return torch.cat([top, bottom], dim=0)


def update_pose(r, t, trans_delta, rot_delta, converged_threshold=1e-4):
    """Left-multiplicative retraction; returns (new_R, new_T, converged)."""
    tau = torch.cat([trans_delta, rot_delta])
    new_w2c = se3_exp(tau) @ rt_to_mat4(r, t)
    converged = torch.linalg.norm(tau) < converged_threshold
    return new_w2c[:3, :3], new_w2c[:3, 3], converged

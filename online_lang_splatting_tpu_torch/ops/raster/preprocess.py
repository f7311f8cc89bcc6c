"""Per-Gaussian screen-space preprocessing (port of ops/raster/preprocess.py).

Plain PyTorch, differentiable through autograd: the view matrix is a
function of the pose perturbation through `lie.se3_exp`, so gradients
reach the pose exactly as `jax.grad` does in the reference. The emission
rect is the JAX package's (3σ rect ∩ the α ≥ 1/255 ellipse AABB), not the
original CUDA rasterizer's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import sh as sh_ops
from . import config as C


class Preprocessed(NamedTuple):
    valid: torch.Tensor      # (P,) bool
    xy: torch.Tensor         # (P, 2) pixel-space mean
    depth: torch.Tensor      # (P,) view-space z
    conic: torch.Tensor      # (P, 3) inverse 2D covariance (a, b, c)
    opacity: torch.Tensor    # (P,)
    color: torch.Tensor      # (P, 3)
    radius: torch.Tensor     # (P,) int32 (0 when culled)
    rect_min: torch.Tensor   # (P, 2) int32 inclusive emission rect start
    rect_max: torch.Tensor   # (P, 2) int32 exclusive emission rect end
    tiles_touched: torch.Tensor  # (P,) int32 emission-rect tile count


def tile_min_power(x, y, ca, cb, cc, x0, y0, tile: int):
    """Exact min over the tile's pixel box of
    Q(d) = 0.5·(ca·dx² + cc·dy²) + cb·dx·dy with d = (x - px, y - py)."""
    hx = x - x0
    lx = x - (x0 + (tile - 1.0))
    hy = y - y0
    ly = y - (y0 + (tile - 1.0))
    inside = (lx <= 0.0) & (hx >= 0.0) & (ly <= 0.0) & (hy >= 0.0)

    def qval(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def edge_x(dxf):
        safe = torch.where(cc != 0.0, cc, torch.ones_like(cc))
        dy = torch.where(cc != 0.0, -cb * dxf / safe, torch.zeros_like(dxf))
        return qval(dxf, torch.minimum(torch.maximum(dy, ly), hy))

    def edge_y(dyf):
        safe = torch.where(ca != 0.0, ca, torch.ones_like(ca))
        dx = torch.where(ca != 0.0, -cb * dyf / safe, torch.zeros_like(dyf))
        return qval(torch.minimum(torch.maximum(dx, lx), hx), dyf)

    q = torch.minimum(
        torch.minimum(edge_x(lx), edge_x(hx)),
        torch.minimum(edge_y(ly), edge_y(hy)),
    )
    return torch.where(inside, torch.zeros_like(q), q)


def tile_keeps_instance(x, y, ca, cb, cc, op, x0, y0, tile: int):
    """True when some pixel of the tile can see alpha >= ALPHA_MIN."""
    q = tile_min_power(x, y, ca, cb, cc, x0, y0, tile)
    return q <= torch.log(torch.clamp(op, min=1e-12) / C.ALPHA_MIN) + 1e-3


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(…, 4) wxyz quaternion -> (…, 3, 3) rotation (no normalization)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1
    )
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1
    )
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1
    )
    return torch.stack([row0, row1, row2], -2)


def compute_cov3d(scales, scale_modifier: float, quats) -> torch.Tensor:
    """World covariance Σ = R S² Rᵀ, (P, 3, 3), same elementwise order as
    the reference."""
    r = quat_to_rotmat(quats)
    s2 = torch.square(scale_modifier * scales)
    rs = r * s2[..., None, :]
    return (
        rs[..., :, 0:1] * r[..., None, :, 0]
        + rs[..., :, 1:2] * r[..., None, :, 1]
        + rs[..., :, 2:3] * r[..., None, :, 2]
    )


def compute_cov2d(mean3d, cov3d, viewmatrix, focal_x, focal_y, tan_fovx,
                  tan_fovy, valid=None) -> torch.Tensor:
    """EWA projection to (P, 3) packed (cov_xx, cov_xy, cov_yy) with the
    +0.3 px low-pass on the diagonal."""
    t = mean3d @ viewmatrix[:3, :3].T + viewmatrix[:3, 3]
    tz = t[..., 2]
    if valid is not None:
        tz = torch.where(valid, tz, torch.ones_like(tz))
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.clamp(t[..., 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[..., 1] / tz, -limy, limy) * tz

    a = focal_x / tz
    b = focal_y / tz
    c = -(focal_x * tx) / (tz * tz)
    d = -(focal_y * ty) / (tz * tz)
    w_rows = viewmatrix[:3, :3]

    def bilinear(i, j):
        wi, wj = w_rows[i], w_rows[j]
        acc = 0.0
        for k in range(3):
            for l in range(3):
                acc = acc + (wi[k] * wj[l]) * cov3d[..., k, l]
        return acc

    s00 = bilinear(0, 0)
    s01 = bilinear(0, 1)
    s02 = bilinear(0, 2)
    s11 = bilinear(1, 1)
    s12 = bilinear(1, 2)
    s22 = bilinear(2, 2)
    cov_xx = a * a * s00 + 2.0 * a * c * s02 + c * c * s22
    cov_xy = a * b * s01 + a * d * s02 + c * b * s12 + c * d * s22
    cov_yy = b * b * s11 + 2.0 * b * d * s12 + d * d * s22
    return torch.stack([cov_xx + C.LOWPASS, cov_xy, cov_yy + C.LOWPASS], -1)


def _tile_index(v: torch.Tensor, tile: int, hi: int) -> torch.Tensor:
    """int-cast toward zero then clamp to [0, hi] (auxiliary.h getRect)."""
    return torch.clamp((v / tile).to(torch.int32), 0, hi)


def preprocess(means3d, scales, quats, opacities, viewmatrix, projmatrix,
               campos, *, shs=None, colors_precomp=None, cov3d_precomp=None,
               sh_degree: int = 3, scale_modifier: float = 1.0, width: int,
               height: int, tan_fovx: float, tan_fovy: float,
               tile: int = C.DEFAULT_TILE, means2d_offset=None) -> Preprocessed:
    """Project Gaussians to screen space. `viewmatrix` is W2C (already
    perturbed by the pose delta); `projmatrix` the full P @ W2C product;
    `campos` a constant."""
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    tiles_x = (width + tile - 1) // tile
    tiles_y = (height + tile - 1) // tile

    p_view = means3d @ viewmatrix[:3, :3].T + viewmatrix[:3, 3]
    depth = p_view[..., 2]
    in_front = depth > C.NEAR_CLIP

    hom = means3d @ projmatrix[:3, :3].T + projmatrix[:3, 3]
    w = means3d @ projmatrix[3, :3] + projmatrix[3, 3]
    w_safe = torch.where(in_front, w, torch.ones_like(w))
    p_w = 1.0 / (w_safe + 1e-7)
    p_proj = hom * p_w[..., None]

    cov3d = cov3d_precomp if cov3d_precomp is not None else compute_cov3d(
        scales, scale_modifier, quats)
    cov = compute_cov2d(means3d, cov3d, viewmatrix, focal_x, focal_y,
                        tan_fovx, tan_fovy, valid=in_front)

    det = cov[..., 0] * cov[..., 2] - cov[..., 1] * cov[..., 1]
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack(
        [cov[..., 2] * det_inv, -cov[..., 1] * det_inv, cov[..., 0] * det_inv],
        -1,
    )

    mid = 0.5 * (cov[..., 0] + cov[..., 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))

    px = (p_proj[..., 0] + 1.0) * width * 0.5 - 0.5
    py = (p_proj[..., 1] + 1.0) * height * 0.5 - 0.5
    xy = torch.stack([px, py], -1)
    if means2d_offset is not None:
        # Zero-valued hook whose gradient is dL/d(xy) per Gaussian (the
        # densification statistic).
        xy = xy + means2d_offset
        px, py = xy[..., 0], xy[..., 1]

    # Geometry below only selects tiles: integer outputs, no gradient.
    with torch.no_grad():
        pxd, pyd, rad = px.detach(), py.detach(), radius.detach()
        rect_min_x = _tile_index(pxd - rad, tile, tiles_x)
        rect_min_y = _tile_index(pyd - rad, tile, tiles_y)
        rect_max_x = _tile_index(pxd + rad + tile - 1, tile, tiles_x)
        rect_max_y = _tile_index(pyd + rad + tile - 1, tile, tiles_y)
        tiles_touched = torch.clamp(rect_max_x - rect_min_x, min=0) * torch.clamp(
            rect_max_y - rect_min_y, min=0)
        valid = in_front & det_ok & (tiles_touched > 0)

        op_flat = opacities.detach().reshape(-1)
        covd = cov.detach()
        tau = 2.0 * torch.log(torch.clamp(op_flat, min=1e-12) / C.ALPHA_MIN)
        psd = det.detach() > 0.0
        ex = torch.sqrt(torch.clamp(tau * covd[..., 0], min=0.0)) + 1e-2
        ey = torch.sqrt(torch.clamp(tau * covd[..., 2], min=0.0)) + 1e-2
        big = torch.full_like(ex, float(2.0 * (tiles_x + tiles_y) * tile))
        ex = torch.where(psd, ex, big)
        ey = torch.where(psd, ey, big)
        emin_x = torch.maximum(rect_min_x, _tile_index(pxd - ex, tile, tiles_x))
        emin_y = torch.maximum(rect_min_y, _tile_index(pyd - ey, tile, tiles_y))
        emax_x = torch.minimum(rect_max_x, _tile_index(pxd + ex + tile, tile, tiles_x))
        emax_y = torch.minimum(rect_max_y, _tile_index(pyd + ey + tile, tile, tiles_y))
        inert = psd & (op_flat < C.ALPHA_MIN)
        emit_touched = torch.where(
            inert, torch.zeros_like(emax_x),
            torch.clamp(emax_x - emin_x, min=0) * torch.clamp(emax_y - emin_y, min=0),
        )
        radius_i = torch.where(valid, rad, torch.zeros_like(rad)).to(torch.int32)
        tiles_touched = torch.where(
            valid, emit_touched, torch.zeros_like(emit_touched)).to(torch.int32)

    if colors_precomp is not None:
        color = colors_precomp
    else:
        color = sh_ops.sh_to_color(sh_degree, shs, means3d, campos.detach())

    return Preprocessed(
        valid=valid,
        xy=xy,
        depth=depth,
        conic=conic,
        opacity=opacities.reshape(-1),
        color=color,
        radius=radius_i,
        rect_min=torch.stack([emin_x, emin_y], -1),
        rect_max=torch.stack([emax_x, emax_y], -1),
        tiles_touched=tiles_touched,
    )

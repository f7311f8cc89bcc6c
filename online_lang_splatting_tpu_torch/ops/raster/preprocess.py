"""Per-Gaussian screen-space preprocessing (port of ops/raster/preprocess.py).

`preprocess` is the plain PyTorch version, differentiable through
autograd: the view matrix is a function of the pose perturbation through
`lie.se3_exp`, so gradients reach the pose exactly as `jax.grad` does in
the reference. The emission rect is the JAX package's (3σ rect ∩ the
α ≥ 1/255 ellipse AABB), not the original CUDA rasterizer's.

`project_gaussians` is the same function as one autograd Function, the
render path's: on CUDA tensors one hand-written forward kernel
(csrc/preprocess_fwd.cu) and a backward of two (csrc/preprocess_bwd.cu:
the hand-derived gradient, then the fixed-order sum of its per-CTA
partials of dL/d(view) and dL/d(full projection)); on CPU tensors the
plain pair, `preprocess` and `preprocess_backward_plain`, which transcribes
the backward kernel's arithmetic. Its gradients are those of autograd on
`preprocess`. The backward kernel writes the per-Gaussian gradients only
when an input needs them, and the matrices' only when the camera does
(tracking: matrices only; mapping: both).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import sh as sh_ops
from . import config as C
from .kernels import KernelStats


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


def _jacobian_terms(t, focal_x, focal_y, tan_fovx, tan_fovy, valid=None):
    """(tz, a, b, c, d) of the EWA Jacobian at view-space means `t`, the
    mean clamped to 1.3·tan(fov); tz := 1 where not `valid`."""
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
    return tz, a, b, c, d


def _view_covariance(cov3d, viewmatrix):
    """The upper entries (s00, s01, s02, s11, s12, s22) of W Σ Wᵀ."""
    w_rows = viewmatrix[:3, :3]

    def bilinear(i, j):
        wi, wj = w_rows[i], w_rows[j]
        acc = 0.0
        for k in range(3):
            for l in range(3):
                acc = acc + (wi[k] * wj[l]) * cov3d[..., k, l]
        return acc

    return (bilinear(0, 0), bilinear(0, 1), bilinear(0, 2), bilinear(1, 1),
            bilinear(1, 2), bilinear(2, 2))


def compute_cov2d(mean3d, cov3d, viewmatrix, focal_x, focal_y, tan_fovx,
                  tan_fovy, valid=None) -> torch.Tensor:
    """EWA projection to (P, 3) packed (cov_xx, cov_xy, cov_yy) with the
    +0.3 px low-pass on the diagonal."""
    t = mean3d @ viewmatrix[:3, :3].T + viewmatrix[:3, 3]
    _, a, b, c, d = _jacobian_terms(t, focal_x, focal_y, tan_fovx, tan_fovy, valid)
    return _cov2d(a, b, c, d, *_view_covariance(cov3d, viewmatrix))


def _cov2d(a, b, c, d, s00, s01, s02, s11, s12, s22) -> torch.Tensor:
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
    prep = _geometry(means3d, scales, quats, opacities, viewmatrix, projmatrix,
                     cov3d_precomp=cov3d_precomp, scale_modifier=scale_modifier,
                     width=width, height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
                     tile=tile, means2d_offset=means2d_offset)
    if colors_precomp is not None:
        return prep._replace(color=colors_precomp)
    return prep._replace(color=sh_ops.sh_to_color(sh_degree, shs, means3d, campos.detach()))


def _geometry(means3d, scales, quats, opacities, viewmatrix, projmatrix, *,
              cov3d_precomp, scale_modifier, width, height, tan_fovx, tan_fovy, tile,
              means2d_offset) -> Preprocessed:
    """`preprocess` less the colour (None)."""
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

    return Preprocessed(
        valid=valid,
        xy=xy,
        depth=depth,
        conic=conic,
        opacity=opacities.reshape(-1),
        color=None,
        radius=radius_i,
        rect_min=torch.stack([emin_x, emin_y], -1),
        rect_max=torch.stack([emax_x, emax_y], -1),
        tiles_touched=tiles_touched,
    )


# ---------------------------------------------------------------------------
# The hand-derived gradient


def _sh_basis(deg: int, x, y, z) -> list:
    """The SH basis functions of degree <= `deg` at unit direction (x, y, z),
    signed as eval_sh adds them (degree 1's y and x terms subtract), and
    their derivatives: [(f_k, (df_k/dx, df_k/dy, df_k/dz)), ...]; None for a
    derivative that is zero."""
    c1, (c20, c21, c22, c23, c24) = sh_ops.SH_C1, sh_ops.SH_C2
    out = [(sh_ops.SH_C0 * torch.ones_like(x), (None, None, None))]
    if deg > 0:
        out += [(-c1 * y, (None, -c1 * torch.ones_like(x), None)),
                (c1 * z, (None, None, c1 * torch.ones_like(x))),
                (-c1 * x, (-c1 * torch.ones_like(x), None, None))]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        out += [(c20 * x * y, (c20 * y, c20 * x, None)),
                (c21 * y * z, (None, c21 * z, c21 * y)),
                (c22 * (2.0 * zz - xx - yy), (-2.0 * c22 * x, -2.0 * c22 * y, 4.0 * c22 * z)),
                (c23 * x * z, (c23 * z, None, c23 * x)),
                (c24 * (xx - yy), (2.0 * c24 * x, -2.0 * c24 * y, None))]
    if deg > 2:
        c30, c31, c32, c33, c34, c35, c36 = sh_ops.SH_C3
        out += [(c30 * y * (3.0 * xx - yy), (6.0 * c30 * x * y, c30 * (3.0 * xx - 3.0 * yy), None)),
                (c31 * x * y * z, (c31 * y * z, c31 * x * z, c31 * x * y)),
                (c32 * y * (4.0 * zz - xx - yy),
                 (-2.0 * c32 * x * y, c32 * (4.0 * zz - xx - 3.0 * yy), 8.0 * c32 * y * z)),
                (c33 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                 (-6.0 * c33 * x * z, -6.0 * c33 * y * z, c33 * (6.0 * zz - 3.0 * xx - 3.0 * yy))),
                (c34 * x * (4.0 * zz - xx - yy),
                 (c34 * (4.0 * zz - 3.0 * xx - yy), -2.0 * c34 * x * y, 8.0 * c34 * x * z)),
                (c35 * z * (xx - yy), (2.0 * c35 * x * z, -2.0 * c35 * y * z, c35 * (xx - yy))),
                (c36 * x * (xx - 3.0 * yy), (c36 * (3.0 * xx - 3.0 * yy), -6.0 * c36 * x * y, None))]
    return out


def _quat_backward(q, g_r):
    """dL/dq (P, 4) of quat_to_rotmat from dL/dR (P, 3, 3)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    g = [[g_r[:, i, j] for j in range(3)] for i in range(3)]
    return 2.0 * torch.stack([
        (-z * g[0][1] + y * g[0][2]) + (z * g[1][0] - x * g[1][2]) + (-y * g[2][0] + x * g[2][1]),
        (y * g[0][1] + z * g[0][2]) + (y * g[1][0] - 2.0 * x * g[1][1] - w * g[1][2])
        + (z * g[2][0] + w * g[2][1] - 2.0 * x * g[2][2]),
        (-2.0 * y * g[0][0] + x * g[0][1] + w * g[0][2]) + (x * g[1][0] + z * g[1][2])
        + (-w * g[2][0] + z * g[2][1] - 2.0 * y * g[2][2]),
        (-2.0 * z * g[0][0] - w * g[0][1] + x * g[0][2])
        + (w * g[1][0] - 2.0 * z * g[1][1] + y * g[1][2]) + (x * g[2][0] + y * g[2][1]),
    ], -1)


def preprocess_backward_plain(means3d, scales, quats, shs, cov3d_precomp, viewmatrix,
                              projmatrix, campos, g_xy, g_depth, g_conic, g_color, *,
                              sh_degree: int, scale_modifier: float, width: int,
                              height: int, tan_fovx: float, tan_fovy: float,
                              gaussian_grads: bool = True, matrix_grads: bool = True):
    """The gradient of `preprocess` (xy, depth, conic, colour) as the
    backward kernel computes it (csrc/preprocess_bwd.cu), for the CPU path
    and the card's comparisons. The cotangents may be None (zero); `shs`
    None at sh_degree -1 (colours precomputed, their gradient the colour's
    cotangent). Returns (d_means3d, d_scales, d_quats, d_shs, d_cov3d,
    d_view (4, 4), d_projmatrix (4, 4)): the per-Gaussian ones None unless
    `gaussian_grads` (d_scales, d_quats None with `cov3d_precomp`, d_cov3d
    None without), the matrices None unless `matrix_grads`."""
    m = means3d
    zero = torch.zeros_like(m[:, 0])

    def col(g, k):
        return zero if g is None else g[:, k]

    gx, gy = col(g_xy, 0), col(g_xy, 1)
    g_a, g_b, g_c = col(g_conic, 0), col(g_conic, 1), col(g_conic, 2)
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy
    w_rows, proj = viewmatrix[:3, :3], projmatrix

    # The forward's quantities, as `preprocess` computes them.
    t = m @ w_rows.T + viewmatrix[:3, 3]
    in_front = t[:, 2] > C.NEAR_CLIP
    hom = m @ proj[:3, :3].T + proj[:3, 3]
    w = m @ proj[3, :3] + proj[3, 3]
    pw = 1.0 / (torch.where(in_front, w, torch.ones_like(w)) + 1e-7)
    sigma = cov3d_precomp if cov3d_precomp is not None else compute_cov3d(
        scales, scale_modifier, quats)
    tz, a, b, c, d = _jacobian_terms(t, focal_x, focal_y, tan_fovx, tan_fovy, in_front)
    view_cov = _view_covariance(sigma, viewmatrix)
    s00, s01, s02, s11, s12, s22 = view_cov
    cov0, cov1, cov2 = _cov2d(a, b, c, d, *view_cov).unbind(-1)
    det = cov0 * cov2 - cov1 * cov1
    det_ok = det != 0.0
    di = 1.0 / torch.where(det_ok, det, torch.ones_like(det))

    # xy = ((hom · pw + 1) · size) · 0.5 - 0.5; pw = 1 / (w + 1e-7), w := 1
    # behind the near plane.
    g_hom0 = ((gx * 0.5) * width) * pw
    g_hom1 = ((gy * 0.5) * height) * pw
    g_w = torch.where(in_front, -(g_hom0 * hom[:, 0] + g_hom1 * hom[:, 1]) * pw, zero)
    g_m = (g_hom0[:, None] * proj[0, :3] + g_hom1[:, None] * proj[1, :3]
           + g_w[:, None] * proj[3, :3])

    # conic = (cov2, -cov1, cov0) / det, det guarded.
    gc0, gc1, gc2 = g_c * di, -g_b * di, g_a * di
    g_di = (g_a * cov2 - g_b * cov1) + g_c * cov0
    g_det = torch.where(det_ok, -g_di * di * di, zero)
    gc0 = gc0 + g_det * cov2
    gc2 = gc2 + g_det * cov0
    gc1 = gc1 - 2.0 * g_det * cov1

    # The 2D covariance from the Jacobian terms and S = W Σ Wᵀ.
    ga = gc0 * (2.0 * a * s00 + 2.0 * c * s02) + gc1 * (b * s01 + d * s02)
    gb = gc2 * (2.0 * b * s11 + 2.0 * d * s12) + gc1 * (a * s01 + c * s12)
    gcc = gc0 * (2.0 * a * s02 + 2.0 * c * s22) + gc1 * (b * s12 + d * s22)
    gd = gc2 * (2.0 * b * s12 + 2.0 * d * s22) + gc1 * (a * s02 + c * s22)
    big_g = torch.stack([
        torch.stack([gc0 * a * a, gc1 * a * b, 2.0 * gc0 * a * c + gc1 * a * d], -1),
        torch.stack([zero, gc2 * b * b, gc1 * c * b + 2.0 * gc2 * b * d], -1),
        torch.stack([zero, zero, gc0 * c * c + gc1 * c * d + gc2 * d * d], -1)], -2)

    # The Jacobian terms from tz and the clamped means.
    q0, q1 = t[:, 0] / tz, t[:, 1] / tz
    tz2 = tz * tz
    g_txc = -focal_x * (gcc / tz2)
    g_tyc = -focal_y * (gd / tz2)
    g_tz2 = -(gcc * c + gd * d) / tz2
    g_tz = (-(ga * focal_x + gb * focal_y) / tz2 + 2.0 * g_tz2 * tz
            + g_txc * torch.clamp(q0, -lim_x, lim_x) + g_tyc * torch.clamp(q1, -lim_y, lim_y))
    g_q0 = torch.where((q0 >= -lim_x) & (q0 <= lim_x), g_txc * tz, zero)
    g_q1 = torch.where((q1 >= -lim_y) & (q1 <= lim_y), g_tyc * tz, zero)
    g_tz = g_tz - (g_q0 * q0 + g_q1 * q1) / tz
    g_t = torch.stack([g_q0 / tz, g_q1 / tz,
                       (zero if g_depth is None else g_depth)
                       + torch.where(in_front, g_tz, zero)], -1)
    g_m = g_m + g_t @ w_rows

    g_view = g_proj = None
    if matrix_grads:
        # S_ij = W_i Σ W_jᵀ over the upper entries: dW = G W Σᵀ + Gᵀ W Σ.
        d_w = (big_g @ (w_rows @ sigma.transpose(-1, -2))
               + big_g.transpose(-1, -2) @ (w_rows @ sigma)).sum(0)
        g_view = torch.zeros_like(viewmatrix)
        g_view[:3, :3] = g_t.T @ m + d_w
        g_view[:3, 3] = g_t.sum(0)
        g_rows = torch.stack([g_hom0, g_hom1, g_w], -1)   # rows 0, 1, 3
        row = torch.cat([m, torch.ones_like(m[:, :1])], -1)
        g_proj = torch.zeros_like(projmatrix)
        g_proj[[0, 1, 3]] = g_rows.T @ row
    if not gaussian_grads:
        return None, None, None, None, None, g_view, g_proj

    # Σ: dΣ = Wᵀ G W.
    g_sigma = w_rows.T @ big_g @ w_rows
    g_scales = g_quats = g_cov3d = None
    if cov3d_precomp is not None:
        g_cov3d = g_sigma
    else:
        # Σ_rc = Σ_k R_rk s2_k R_ck, s2 = (modifier · scale)².
        rot = quat_to_rotmat(quats)
        s = scale_modifier * scales
        g_rot = ((g_sigma + g_sigma.transpose(-1, -2)) @ rot) * (s * s)[:, None, :]
        g_scales = ((g_sigma @ rot) * rot).sum(1) * 2.0 * s * scale_modifier
        g_quats = _quat_backward(quats, g_rot)

    g_shs = None
    if sh_degree >= 0:
        # colour = max(eval_sh(sh, unit(m - campos)) + 0.5, 0).
        v = m - campos
        norm = torch.linalg.norm(v, dim=-1)
        nc = torch.clamp(norm, min=1e-8)
        u = v / nc[:, None]
        raw = sh_ops.eval_sh(sh_degree, shs, u) + 0.5
        g_raw = torch.where(raw >= 0.0, torch.zeros_like(raw) if g_color is None else g_color,
                            torch.zeros_like(raw))
        g_shs = torch.zeros_like(shs)
        g_u = torch.zeros_like(u)
        for k, (f, df) in enumerate(_sh_basis(sh_degree, u[:, 0], u[:, 1], u[:, 2])):
            g_shs[:, k] = f[:, None] * g_raw
            s_k = (g_raw * shs[:, k]).sum(-1)
            for axis, dfa in enumerate(df):
                if dfa is not None:
                    g_u[:, axis] = g_u[:, axis] + s_k * dfa
        if sh_degree > 0:
            g_nc = -(g_u * v).sum(-1) / (nc * nc)
            g_norm = torch.where(norm >= 1e-8, g_nc, zero)
            g_m = g_m + g_u / nc[:, None] + torch.where(
                (norm != 0.0)[:, None], g_norm[:, None] * v / norm[:, None], torch.zeros_like(v))
    return g_m, g_scales, g_quats, g_shs, g_cov3d, g_view, g_proj


# ---------------------------------------------------------------------------
# The autograd Function: kernels on CUDA tensors, the plain pair on CPU ones

# Launches of the forward kernel and of the backward pair (the gradient and
# the reduce of its matrix partials), and calls of their plain versions,
# per SH degree (-1: colours precomputed).
FWD_STATS = KernelStats()
BWD_STATS = KernelStats()


class _Camera(NamedTuple):
    sh_degree: int       # -1: colours precomputed
    scale_modifier: float
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float
    tile: int

    def kernel_scalars(self) -> dict:
        """The launch's float scalars, computed in double as the plain
        version's Python floats (the launch rounds them to float)."""
        return dict(width=self.width, height=self.height,
                    focal_x=self.width / (2.0 * self.tan_fovx),
                    focal_y=self.height / (2.0 * self.tan_fovy),
                    lim_x=1.3 * self.tan_fovx, lim_y=1.3 * self.tan_fovy,
                    scale_modifier=self.scale_modifier)


def _check_cuda(name: str, t, device):
    if t is not None and t.dtype != torch.float32:
        raise ValueError(f"the preprocess kernels take float32; {name} is {t.dtype}")
    if t is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _cotangent_rows(g):
    """A cotangent as the backward kernel reads it: rows of adjacent
    entries at any row stride (a column slice of the blend's per-Gaussian
    table is read in place)."""
    if g is None or g.dim() == 1 or g.stride(1) == 1:
        return g
    return g.contiguous()


class _Preprocess(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means3d, scales, quats, shs, cov3d, viewmatrix, projmatrix, campos,
                offset, opacities, cam: _Camera):
        ctx.set_materialize_grads(False)
        deg = cam.sh_degree
        if means3d.is_cuda:
            from . import kernels

            dev = means3d.device
            ins = []
            for name, x in (("means3d", means3d), ("scales", scales), ("quats", quats),
                            ("opacities", opacities), ("shs", shs), ("cov3d_precomp", cov3d),
                            ("viewmatrix", viewmatrix), ("projmatrix", projmatrix),
                            ("campos", campos), ("means2d_offset", offset)):
                _check_cuda(name, x, dev)
                ins.append(None if x is None else x.contiguous())
            means3d, scales, quats, _, shs, cov3d, viewmatrix, projmatrix, campos, _ = ins
            p = means3d.shape[0]
            f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
            outs = (torch.empty((p, 2), **f32), torch.empty(p, **f32), torch.empty((p, 3), **f32),
                    torch.empty((p, 3), **f32) if deg >= 0 else None,
                    torch.empty(p, dtype=torch.bool, device=dev), torch.empty(p, **i32),
                    torch.empty((p, 2), **i32), torch.empty((p, 2), **i32), torch.empty(p, **i32))
            kernels.launch_preprocess_forward(
                ins, outs, sh_degree=deg, sh_coeffs=0 if shs is None else shs.shape[1],
                tile=cam.tile, **cam.kernel_scalars())
            FWD_STATS.count(deg, plain=False)
            xy, depth, conic, color, valid, radius, rect_min, rect_max, tiles = outs
        else:
            prep = _geometry(means3d, scales, quats, opacities, viewmatrix, projmatrix,
                             cov3d_precomp=cov3d, scale_modifier=cam.scale_modifier,
                             width=cam.width, height=cam.height, tan_fovx=cam.tan_fovx,
                             tan_fovy=cam.tan_fovy, tile=cam.tile, means2d_offset=offset)
            color = (sh_ops.sh_to_color(deg, shs, means3d, campos) if deg >= 0 else None)
            FWD_STATS.count(deg, plain=True)
            xy, depth, conic, valid, radius, rect_min, rect_max, tiles = (
                prep.xy, prep.depth, prep.conic, prep.valid, prep.radius, prep.rect_min,
                prep.rect_max, prep.tiles_touched)
        ctx.save_for_backward(means3d, scales, quats, shs, cov3d, viewmatrix, projmatrix,
                              campos)
        ctx.cam = cam
        ctx.mark_non_differentiable(valid, radius, rect_min, rect_max, tiles)
        return xy, depth, conic, color, valid, radius, rect_min, rect_max, tiles

    @staticmethod
    def backward(ctx, g_xy, g_depth, g_conic, g_color, *_ints):
        needs = ctx.needs_input_grad
        gauss, mats = any(needs[:5]), needs[5] or needs[6]
        cam = ctx.cam
        cots = (g_xy, g_depth, g_conic, g_color if cam.sh_degree >= 0 else None)
        g_offset = g_xy if needs[8] else None
        if not (gauss or mats) or all(g is None for g in cots):
            return (None,) * 8 + (g_offset, None, None)
        means3d, scales, quats, shs, cov3d, view, proj, campos = ctx.saved_tensors
        if means3d.is_cuda:
            from . import kernels

            cots = tuple(_cotangent_rows(g) for g in cots)
            for name, g in zip(("xy", "depth", "conic", "color"), cots):
                _check_cuda(f"the cotangent of {name}", g, means3d.device)
            grads = (torch.empty_like(means3d),
                     None if cov3d is not None else torch.empty_like(scales),
                     None if cov3d is not None else torch.empty_like(quats),
                     None if shs is None else torch.empty_like(shs),
                     None if cov3d is None else torch.empty_like(cov3d)) if gauss else (None,) * 5
            partials = (torch.empty((kernels.preprocess_blocks(means3d.shape[0]), 32),
                                    dtype=torch.float32, device=means3d.device)
                        if mats else None)
            kernels.launch_preprocess_backward(
                (means3d, scales, quats, shs, cov3d, view, proj, campos), cots, grads, partials,
                sh_degree=cam.sh_degree, sh_coeffs=0 if shs is None else shs.shape[1],
                **cam.kernel_scalars())
            g_view = g_proj = None
            if mats:
                matrices = torch.empty((2, 4, 4), dtype=torch.float32, device=means3d.device)
                kernels.launch_preprocess_reduce(partials, matrices)
                g_view, g_proj = matrices[0], matrices[1]
            BWD_STATS.count(cam.sh_degree, plain=False)
            g_means, g_scales, g_quats, g_shs, g_cov3d = grads
        else:
            g_means, g_scales, g_quats, g_shs, g_cov3d, g_view, g_proj = (
                preprocess_backward_plain(
                    means3d, scales, quats, shs, cov3d, view, proj, campos, *cots,
                    sh_degree=cam.sh_degree, scale_modifier=cam.scale_modifier,
                    width=cam.width, height=cam.height, tan_fovx=cam.tan_fovx,
                    tan_fovy=cam.tan_fovy, gaussian_grads=gauss, matrix_grads=mats))
            BWD_STATS.count(cam.sh_degree, plain=True)
        grads = (g_means, g_scales, g_quats, g_shs, g_cov3d, g_view, g_proj)
        return (*(g if need else None for g, need in zip(grads, needs)), None, g_offset,
                None, None)


def project_gaussians(means3d, scales, quats, opacities, viewmatrix, projmatrix, campos, *,
                      shs=None, colors_precomp=None, cov3d_precomp=None,
                      sh_degree: int = 3, scale_modifier: float = 1.0, width: int,
                      height: int, tan_fovx: float, tan_fovy: float,
                      tile: int = C.DEFAULT_TILE, means2d_offset=None) -> Preprocessed:
    """`preprocess` (same arguments, same outputs, the gradients of autograd
    on it) as one autograd Function: the kernels on CUDA tensors, the plain
    pair on CPU tensors. `campos` is a constant."""
    if colors_precomp is None and shs is None:
        raise ValueError("preprocess needs shs or colors_precomp")
    cam = _Camera(sh_degree if colors_precomp is None else -1, scale_modifier, width, height,
                  tan_fovx, tan_fovy, tile)
    with_cov = cov3d_precomp is not None
    xy, depth, conic, color, valid, radius, rect_min, rect_max, tiles = _Preprocess.apply(
        means3d, None if with_cov else scales, None if with_cov else quats,
        shs if colors_precomp is None else None, cov3d_precomp, viewmatrix, projmatrix,
        campos.detach(), means2d_offset, opacities.detach().reshape(-1), cam)
    return Preprocessed(
        valid=valid, xy=xy, depth=depth, conic=conic, opacity=opacities.reshape(-1),
        color=colors_precomp if colors_precomp is not None else color, radius=radius,
        rect_min=rect_min, rect_max=rect_max, tiles_touched=tiles)

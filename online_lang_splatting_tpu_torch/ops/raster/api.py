"""Public differentiable rasterization API (port of ops/raster/api.py).

Backends:
  "oracle" — dense compositor (exact, O(P·H·W); tests).
  "cuda"   — binning + the hand-written blend kernels; on CPU tensors the
             kernels' plain PyTorch versions.
Both take the preprocess of `preprocess.project_gaussians` (the
hand-written preprocess kernels on CUDA tensors). Camera-pose gradients
come from the (rho, theta) perturbation applied through `lie.se3_exp`
before the view and full projection are formed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import lie
from . import config as C
from .oracle import blend_oracle
from .preprocess import project_gaussians
from .tiled import blend_tiled


class RasterSettings(NamedTuple):
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    sh_degree: int = 3
    scale_modifier: float = 1.0
    tile: int = C.DEFAULT_TILE
    backend: str = "cuda"
    # stats=False skips n_touched/n_contrib bookkeeping (outputs zero) for
    # render loops that never read them (tracking iterations).
    stats: bool = True


class RasterOutput(NamedTuple):
    color: torch.Tensor      # (3, H, W)
    language: torch.Tensor   # (F, H, W)
    depth: torch.Tensor      # (1, H, W)
    opacity: torch.Tensor    # (1, H, W)
    radii: torch.Tensor      # (P,) int32
    n_touched: torch.Tensor  # (P,) int32
    final_t: torch.Tensor    # (H, W)
    n_contrib: torch.Tensor  # (H, W) int32
    num_instances: int       # pre-cull Gaussian-tile instances
    overflow: bool           # always False: buffers are sized per render


def project(means3d, opacities, scales, quats, *, viewmatrix, projmatrix,
            settings: RasterSettings, shs=None, colors_precomp=None,
            cov3d_precomp=None, cam_trans_delta=None, cam_rot_delta=None,
            means2d_offset=None):
    """Preprocess stage of `rasterize`: the pose perturbation, the full
    projection and the per-Gaussian screen-space quantities."""
    dtype, device = means3d.dtype, means3d.device
    if cam_trans_delta is not None or cam_rot_delta is not None:
        zero = torch.zeros(3, dtype=dtype, device=device)
        rho = cam_trans_delta if cam_trans_delta is not None else zero
        theta = cam_rot_delta if cam_rot_delta is not None else zero
        viewmatrix = lie.se3_exp(torch.cat([rho, theta])) @ viewmatrix
    full_proj = projmatrix @ viewmatrix
    # Camera centre: constant with respect to the pose deltas.
    w2c0 = viewmatrix.detach()
    campos = -w2c0[:3, :3].T @ w2c0[:3, 3]
    return project_gaussians(
        means3d, scales, quats, opacities, viewmatrix, full_proj, campos,
        shs=shs, colors_precomp=colors_precomp, cov3d_precomp=cov3d_precomp,
        sh_degree=settings.sh_degree, scale_modifier=settings.scale_modifier,
        width=settings.image_width, height=settings.image_height,
        tan_fovx=settings.tanfovx, tan_fovy=settings.tanfovy,
        tile=settings.tile, means2d_offset=means2d_offset,
    )


def rasterize(means3d, opacities, scales, quats, *, viewmatrix, projmatrix,
              settings: RasterSettings, shs=None, colors_precomp=None,
              cov3d_precomp=None, language_features=None, bg=None,
              cam_trans_delta=None, cam_rot_delta=None,
              means2d_offset=None) -> RasterOutput:
    """Differentiable splat render. viewmatrix: (4,4) W2C; projmatrix: the
    intrinsics projection P (the full P @ W2C is formed here)."""
    if bg is None:
        bg = torch.zeros(3, dtype=means3d.dtype, device=means3d.device)
    prep = project(
        means3d, opacities, scales, quats, viewmatrix=viewmatrix,
        projmatrix=projmatrix, settings=settings, shs=shs,
        colors_precomp=colors_precomp, cov3d_precomp=cov3d_precomp,
        cam_trans_delta=cam_trans_delta, cam_rot_delta=cam_rot_delta,
        means2d_offset=means2d_offset,
    )
    if settings.backend == "oracle":
        out = blend_oracle(prep, language_features, bg,
                           width=settings.image_width,
                           height=settings.image_height, tile=settings.tile)
    elif settings.backend == "cuda":
        out = blend_tiled(prep, language_features, bg,
                          width=settings.image_width,
                          height=settings.image_height, tile=settings.tile,
                          stats=settings.stats)
    else:
        raise ValueError(f"unknown raster backend {settings.backend!r}")
    return RasterOutput(
        color=out.color, language=out.language, depth=out.depth,
        opacity=out.opacity, radii=prep.radius, n_touched=out.n_touched,
        final_t=out.final_t, n_contrib=out.n_contrib,
        num_instances=out.num_instances, overflow=False,
    )

"""Bridge from GaussianParams to the rasterizer (port of slam/renderer.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import gaussians as G
from ..ops.raster import RasterSettings, rasterize


class RenderInputs(NamedTuple):
    """Activated per-Gaussian tensors (constant during tracking)."""

    xyz: torch.Tensor
    opacity: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    shs: torch.Tensor
    language: torch.Tensor


def activate(params: G.GaussianParams, aux_active: torch.Tensor) -> RenderInputs:
    return RenderInputs(
        xyz=params.xyz,
        opacity=torch.sigmoid(params.opacity[:, 0]) * aux_active,
        scales=torch.exp(params.scaling),
        quats=params.rotation
        / torch.linalg.norm(params.rotation, dim=-1, keepdim=True),
        shs=torch.cat([params.features_dc, params.features_rest], dim=1),
        language=params.language,
    )


def render(inputs: RenderInputs, viewmatrix, projmatrix,
           settings: RasterSettings, *, bg=None, cam_trans_delta=None,
           cam_rot_delta=None, means2d_offset=None):
    return rasterize(
        inputs.xyz, inputs.opacity, inputs.scales, inputs.quats,
        shs=inputs.shs, language_features=inputs.language,
        viewmatrix=viewmatrix, projmatrix=projmatrix, settings=settings,
        bg=bg, cam_trans_delta=cam_trans_delta, cam_rot_delta=cam_rot_delta,
        means2d_offset=means2d_offset,
    )

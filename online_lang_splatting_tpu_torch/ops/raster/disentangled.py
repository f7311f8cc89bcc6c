"""Disentangle-optim rasterization (port of ops/raster/disentangled.py).

The reference's second engine gives the language channels their own
geometry: a separate opacity, scale and rotation per Gaussian, with its
own preprocess, binning and blend, and duplicated outputs (radii_lang,
opacity_lang, n_touched_lang). Here that is two calls of the shared
pipeline: colour and depth on the colour geometry (the blend kernels at
C = 4), then the language channels on the language geometry with zero
colours (C = 3 + F + 1; 7 at the reference's 3 channels). Both passes share
the positions and one SE(3) perturbation of the view, so the pose
gradients of the two passes sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import lie
from .api import RasterSettings, rasterize


class DisentangledOutput(NamedTuple):
    color: torch.Tensor
    language: torch.Tensor
    depth: torch.Tensor
    opacity: torch.Tensor
    opacity_lang: torch.Tensor
    radii: torch.Tensor
    radii_lang: torch.Tensor
    n_touched: torch.Tensor
    n_touched_lang: torch.Tensor
    final_t: torch.Tensor
    final_t_lang: torch.Tensor


def rasterize_disentangled(means3d, opacities, scales, quats, opacities_lang,
                           scales_lang, quats_lang, *, viewmatrix, projmatrix,
                           settings: RasterSettings, shs=None,
                           colors_precomp=None, language_features=None,
                           bg=None, cam_trans_delta=None,
                           cam_rot_delta=None) -> DisentangledOutput:
    dtype, device = means3d.dtype, means3d.device
    if cam_trans_delta is not None or cam_rot_delta is not None:
        zero = torch.zeros(3, dtype=dtype, device=device)
        rho = cam_trans_delta if cam_trans_delta is not None else zero
        theta = cam_rot_delta if cam_rot_delta is not None else zero
        viewmatrix = lie.se3_exp(torch.cat([rho, theta])) @ viewmatrix
    color_out = rasterize(
        means3d, opacities, scales, quats, viewmatrix=viewmatrix,
        projmatrix=projmatrix, settings=settings, shs=shs,
        colors_precomp=colors_precomp, bg=bg)
    p = means3d.shape[0]
    lang = (language_features if language_features is not None
            else torch.zeros((p, 3), dtype=dtype, device=device))
    lang_out = rasterize(
        means3d, opacities_lang, scales_lang, quats_lang,
        viewmatrix=viewmatrix, projmatrix=projmatrix, settings=settings,
        colors_precomp=torch.zeros((p, 3), dtype=dtype, device=device),
        language_features=lang)
    return DisentangledOutput(
        color=color_out.color, language=lang_out.language,
        depth=color_out.depth, opacity=color_out.opacity,
        opacity_lang=lang_out.opacity, radii=color_out.radii,
        radii_lang=lang_out.radii, n_touched=color_out.n_touched,
        n_touched_lang=lang_out.n_touched, final_t=color_out.final_t,
        final_t_lang=lang_out.final_t)

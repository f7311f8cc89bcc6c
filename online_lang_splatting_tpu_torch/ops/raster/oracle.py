"""Dense alpha-compositing oracle (port of ops/raster/oracle.py).

Front-to-back compositing in global depth order over every pixel, with the
tile-rect visibility cut and the exact per-(Gaussian, tile) cull, so its
per-tile instance sequences (and hence `n_contrib`) match the tiled path.
O(P·H·W): the autodiff reference of the tests, not a fast path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import config as C
from .preprocess import Preprocessed, tile_keeps_instance


class BlendOutput(NamedTuple):
    color: torch.Tensor      # (3, H, W)
    language: torch.Tensor   # (F, H, W)
    depth: torch.Tensor      # (1, H, W)
    opacity: torch.Tensor    # (1, H, W)
    final_t: torch.Tensor    # (H, W)
    n_contrib: torch.Tensor  # (H, W) int32
    n_touched: torch.Tensor  # (P,) int32
    num_instances: int = 0
    overflow: bool = False


def blend_oracle(prep: Preprocessed, language_features, bg, *, width: int,
                 height: int, tile: int = C.DEFAULT_TILE) -> BlendOutput:
    p = prep.xy.shape[0]
    device, dtype = prep.xy.device, prep.xy.dtype
    lang = (language_features if language_features is not None
            else torch.zeros((p, 0), dtype=dtype, device=device))
    f_lang = lang.shape[1]

    sort_depth = torch.where(prep.valid, prep.depth.detach(),
                             torch.full_like(prep.depth, float("inf")))
    order = torch.argsort(sort_depth, stable=True)

    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2).to(dtype)
    tile_xy = (pix / tile).to(torch.int32)
    tile_x0 = (tile_xy[:, 0] * tile).to(dtype)
    tile_y0 = (tile_xy[:, 1] * tile).to(dtype)
    n_pix = pix.shape[0]

    t = torch.ones(n_pix, dtype=dtype, device=device)
    done = torch.zeros(n_pix, dtype=torch.bool, device=device)
    acc_c = torch.zeros((n_pix, 3), dtype=dtype, device=device)
    acc_l = torch.zeros((n_pix, f_lang), dtype=dtype, device=device)
    acc_d = torch.zeros(n_pix, dtype=dtype, device=device)
    n_contrib = torch.zeros(n_pix, dtype=torch.int32, device=device)
    range_pos = torch.zeros(n_pix, dtype=torch.int32, device=device)
    touched = torch.zeros(p, dtype=torch.int32, device=device)

    for g in order.tolist():
        if not bool(prep.valid[g]):
            continue
        g_xy, g_conic, g_op = prep.xy[g], prep.conic[g], prep.opacity[g]
        rmin, rmax = prep.rect_min[g], prep.rect_max[g]
        in_rect = ((tile_xy[:, 0] >= rmin[0]) & (tile_xy[:, 0] < rmax[0])
                   & (tile_xy[:, 1] >= rmin[1]) & (tile_xy[:, 1] < rmax[1]))
        gx, gy = g_xy.detach()
        ca, cb, cc = g_conic.detach()
        in_rect = in_rect & tile_keeps_instance(
            gx, gy, ca, cb, cc, g_op.detach(), tile_x0, tile_y0, tile)
        if not bool(in_rect.any()):
            continue
        d = g_xy[None, :] - pix
        power = (-0.5 * (g_conic[0] * d[:, 0] ** 2 + g_conic[2] * d[:, 1] ** 2)
                 - g_conic[1] * d[:, 0] * d[:, 1])
        alpha = torch.clamp(g_op * torch.exp(power), max=C.ALPHA_MAX)
        skip = (power > 0.0) | (alpha < C.ALPHA_MIN) | ~in_rect
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

        test_t = t * (1.0 - alpha)
        stop_now = ~skip & (test_t < C.T_EPS) & ~done
        contrib = ~skip & ~done & ~stop_now
        w = torch.where(contrib, alpha * t, torch.zeros_like(alpha))
        acc_c = acc_c + w[:, None] * prep.color[g][None, :]
        acc_l = acc_l + w[:, None] * lang[g][None, :]
        acc_d = acc_d + w * prep.depth[g]
        touched[g] = int((contrib & (test_t.detach() > C.N_TOUCHED_T)).sum())
        range_pos = range_pos + in_rect.to(torch.int32)
        n_contrib = torch.where(contrib, range_pos, n_contrib)
        t = torch.where(contrib, test_t, t)
        done = done | stop_now

    color = (acc_c + t[:, None] * bg[None, :]).T.reshape(3, height, width)
    return BlendOutput(
        color=color,
        language=acc_l.T.reshape(f_lang, height, width),
        depth=acc_d.reshape(1, height, width),
        opacity=(1.0 - t).reshape(1, height, width),
        final_t=t.reshape(height, width),
        n_contrib=n_contrib.reshape(height, width),
        n_touched=touched,
        num_instances=int(prep.tiles_touched.sum()),
        overflow=False,
    )

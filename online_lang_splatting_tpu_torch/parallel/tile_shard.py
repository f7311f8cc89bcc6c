"""Band-parallel rasterization over a device mesh (port of
parallel/tile_shard.py).

Parallelism for a single render: the image's tile rows are split into
horizontal bands, one per shard of the mesh (parallel/mesh.py). Each shard
preprocesses the whole frame on its device (cheap, replicated), bins and
blends only its own band, and the per-Gaussian gradients sum back through
`.to` (the psum of the JAX package's shard_map transpose). Tracking, one
camera and one render per iteration, scales with the number of devices
this way; mapping shards keyframes instead (parallel/mesh.py).

The decomposition is exact: a band's tile rects are the full-frame rects
intersected with the band, depth order within a tile is unchanged, and the
last band's rows past the image count toward no n_touched (the forward
kernel's `py_limit`). The bands assemble into the single-device image, so
a loss on it (tracking's, slam.frontend.tracking_run) is the single-device
loss, and gradients differ from the single-device path only in float
accumulation order.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..ops.raster import RasterSettings
from ..ops.raster.api import project
from ..ops.raster.preprocess import Preprocessed
from ..ops.raster.tiled import blend_tiled
from ..slam.renderer import RenderInputs
from .mesh import Mesh, to_device


def band_layout(height: int, tile: int, n: int):
    """Split `height` into n tile-row bands. Returns (band_tiles_y, band_h,
    padded_h)."""
    tiles_y = (height + tile - 1) // tile
    tiles_y_pad = -(-tiles_y // n) * n
    band_tiles_y = tiles_y_pad // n
    band_h = band_tiles_y * tile
    return band_tiles_y, band_h, band_h * n


def crop_band(prep: Preprocessed, y0: int, *, band_h: int,
              tile: int) -> Preprocessed:
    """Restrict full-frame preprocessed Gaussians to the band starting at
    pixel row y0: shift screen y and intersect the full-frame tile rect
    (which already holds the image clipping) with the band's tile rows, so
    each tile's instances are exactly the single-device ones."""
    band_tiles_y = band_h // tile
    k_tiles = y0 // tile
    xy = prep.xy - prep.xy.new_tensor([0.0, float(y0)])
    rect_min_y = torch.clamp(prep.rect_min[:, 1] - k_tiles, 0, band_tiles_y)
    rect_max_y = torch.clamp(prep.rect_max[:, 1] - k_tiles, 0, band_tiles_y)
    tiles_touched = (torch.clamp(prep.rect_max[:, 0] - prep.rect_min[:, 0], min=0)
                     * torch.clamp(rect_max_y - rect_min_y, min=0))
    tiles_touched = torch.where(prep.valid, tiles_touched,
                                torch.zeros_like(tiles_touched))
    return prep._replace(
        valid=prep.valid & (tiles_touched > 0),
        xy=xy,
        rect_min=torch.stack([prep.rect_min[:, 0], rect_min_y], -1),
        rect_max=torch.stack([prep.rect_max[:, 0], rect_max_y], -1),
        tiles_touched=tiles_touched.to(torch.int32),
    )


def _band_blend(inputs: RenderInputs, view, proj, settings: RasterSettings,
                band_idx: int, *, band_h: int, bg=None, cam_trans_delta=None,
                cam_rot_delta=None):
    """Preprocess (full frame) + band crop + blend kernels for one band, on
    the device of `inputs`. Returns the band's BlendOutput and the radii."""
    if bg is None:
        bg = torch.zeros(3, dtype=inputs.xyz.dtype, device=inputs.xyz.device)
    prep = project(
        inputs.xyz, inputs.opacity, inputs.scales, inputs.quats,
        viewmatrix=view, projmatrix=proj, settings=settings, shs=inputs.shs,
        cam_trans_delta=cam_trans_delta, cam_rot_delta=cam_rot_delta)
    band = crop_band(prep, band_idx * band_h, band_h=band_h, tile=settings.tile)
    out = blend_tiled(
        band, inputs.language, bg, width=settings.image_width, height=band_h,
        tile=settings.tile, stats=settings.stats,
        # The last band's lower rows fall outside the image: the row limit
        # keeps n_touched equal to a full-frame render's.
        py_limit=min(max(settings.image_height - band_idx * band_h, 0), band_h))
    return out, prep.radius


class BandedOutput(NamedTuple):
    color: torch.Tensor      # (3, H, W)
    language: torch.Tensor   # (F, H, W)
    depth: torch.Tensor      # (1, H, W)
    opacity: torch.Tensor    # (1, H, W)
    radii: torch.Tensor      # (P,) int32
    n_touched: torch.Tensor  # (P,) int32, summed over the bands
    final_t: torch.Tensor    # (H, W)


def banded_render(mesh: Mesh, inputs: RenderInputs, view, proj,
                  settings: RasterSettings, *, bg=None, cam_trans_delta=None,
                  cam_rot_delta=None) -> BandedOutput:
    """slam.renderer.render's arguments and outputs, band-parallel: one band
    per shard, each on its own device, assembled on the mesh's first device
    (heights padded to the band grid, then cropped). Differentiable; the
    Gaussians' and the pose perturbation's gradients sum over the bands."""
    h = settings.image_height
    _, band_h, _ = band_layout(h, settings.tile, mesh.size)
    d0 = mesh.devices[0]
    bands = [_band_blend(to_device(inputs, dev), view.to(dev), proj.to(dev), settings,
                         k, band_h=band_h, bg=to_device(bg, dev),
                         cam_trans_delta=to_device(cam_trans_delta, dev),
                         cam_rot_delta=to_device(cam_rot_delta, dev))
             for k, dev in enumerate(mesh.devices)]

    def cat(field, dim):
        return torch.cat([getattr(o, field).to(d0) for o, _ in bands], dim)

    return BandedOutput(
        color=cat("color", 1)[:, :h], language=cat("language", 1)[:, :h],
        depth=cat("depth", 1)[:, :h], opacity=cat("opacity", 1)[:, :h],
        radii=bands[0][1].to(d0),
        n_touched=sum(o.n_touched.to(d0) for o, _ in bands),
        final_t=cat("final_t", 0)[:h])


def make_banded_render(mesh: Mesh, settings: RasterSettings):
    """(inputs, view, proj) -> BandedOutput: `banded_render` at `settings`."""
    return partial(banded_render, mesh, settings=settings)


def make_banded_tracking_run(mesh: Mesh, settings: RasterSettings,
                             max_iters: int, **kw):
    """Band-parallel whole-frame tracking: slam.frontend.tracking_run (the
    same arguments, keywords and outputs) rendering through
    `banded_render`, so each shard renders and differentiates its own band
    and the pose gradients sum on the first device."""
    from ..slam.frontend import tracking_run

    return partial(tracking_run, settings=settings, max_iters=max_iters,
                   render_fn=partial(banded_render, mesh), **kw)

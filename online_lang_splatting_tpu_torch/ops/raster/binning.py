"""Tile binning (port of ops/raster/binning.py:bin_gaussians_sorted).

Gaussian → tile instance duplication in (tile, depth, Gaussian id) order:

1. a stable depth pre-sort of the Gaussians (ties by id);
2. expansion of each Gaussian over its emission rect, in that order;
3. the exact per-(Gaussian, tile) alpha cull (`tile_keeps_instance`);
   culled instances are dropped;
4. a stable sort by tile, giving `starts` / `tile_counts` per tile.

The emission order (step 2 after the cull) is also each Gaussian's fixed
order of its instances, as the JAX binning's `s_emit` / `emit_start`
carry it: a Gaussian's kept instances are contiguous there, in increasing
tile id. `EmissionOrder` gives the sorted instance at each emission index
and each Gaussian's range, which the backward's reduce kernel walks to
sum the per-instance rows per Gaussian in an order that does not change
from run to run.

The instance arrays are sized from the exact count of each render, so the
JAX package's fixed buckets, overflow flag and grow-and-replay are not
needed: `overflow` is always False. A render syncs with the host three
times: the instance count that sizes the expansion, and the two
boolean-mask compactions of the culled instances (each sizes its output
from the mask on the host). `num_instances` is the pre-cull demand, as in
the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils.profiling import span
from .preprocess import Preprocessed, tile_keeps_instance


class EmissionOrder(NamedTuple):
    inst: torch.Tensor   # (S,) int32 sorted instance index per emission index
    start: torch.Tensor  # (P,) int32 first emission index of each Gaussian id
    count: torch.Tensor  # (P,) int32 kept instances of each Gaussian id


class SortedBinning(NamedTuple):
    s_gid: torch.Tensor        # (S,) int32 Gaussian id per sorted instance
    s_tile: torch.Tensor       # (S,) int32 tile id per sorted instance
    starts: torch.Tensor       # (T,) int32 first sorted index of each tile
    tile_counts: torch.Tensor  # (T,) int32 instances per tile
    num_instances: int         # pre-cull (Gaussian, tile) demand
    emission: EmissionOrder    # each Gaussian's instances, in a fixed order


def bin_gaussians_sorted(prep: Preprocessed, *, tiles_x: int, tiles_y: int,
                         tile_px: int) -> SortedBinning:
    device = prep.depth.device
    num_tiles = tiles_x * tiles_y
    p = prep.depth.shape[0]
    tt = prep.tiles_touched.to(torch.int64)
    depth = prep.depth.detach()
    d_key = torch.where(tt > 0, depth, torch.full_like(depth, float("inf")))
    _, perm = torch.sort(d_key, stable=True)
    tt_s = tt[perm]
    with span("sync.binning.count"):  # the first of a render's three host syncs
        total = int(tt_s.sum().item())
    if total == 0:
        zi = torch.zeros(0, dtype=torch.int32, device=device)
        zt = torch.zeros(num_tiles, dtype=torch.int32, device=device)
        zp = torch.zeros(p, dtype=torch.int32, device=device)
        return SortedBinning(zi, zi, zt, zt, 0, EmissionOrder(zi, zp, zp))

    # Expansion in depth order: instance i belongs to depth-sorted
    # Gaussian g(i) at local index i - offset[g].
    offsets = torch.cumsum(tt_s, 0) - tt_s
    g_sorted = torch.repeat_interleave(
        torch.arange(p, device=device), tt_s, output_size=total
    )
    gid = perm[g_sorted]
    local = torch.arange(total, device=device) - offsets[g_sorted]
    rmin = prep.rect_min[gid].to(torch.int64)
    width = torch.clamp(prep.rect_max[gid, 0].to(torch.int64) - rmin[:, 0], min=1)
    ly = local // width
    lx = local - ly * width
    tx = rmin[:, 0] + lx
    ty = rmin[:, 1] + ly

    xy = prep.xy.detach()[gid]
    conic = prep.conic.detach()[gid]
    keep = tile_keeps_instance(
        xy[:, 0], xy[:, 1], conic[:, 0], conic[:, 1], conic[:, 2],
        prep.opacity.detach()[gid],
        (tx * tile_px).to(torch.float32), (ty * tile_px).to(torch.float32),
        tile_px,
    )
    tile_id = ty * tiles_x + tx
    with span("sync.binning.keep"):
        tile_id = tile_id[keep]
    with span("sync.binning.keep"):
        gid = gid[keep]
    s_tile, order = torch.sort(tile_id, stable=True)
    s_gid = gid[order].to(torch.int32)
    s_tile = s_tile.to(torch.int32)

    tile_ids = torch.arange(num_tiles, device=device, dtype=torch.int32)
    starts = torch.searchsorted(s_tile, tile_ids, side="left").to(torch.int32)
    ends = torch.searchsorted(s_tile, tile_ids, side="right").to(torch.int32)
    return SortedBinning(s_gid, s_tile, starts, ends - starts, total,
                         _emission_order(keep, order, offsets, tt_s, perm))


def _emission_order(keep, order, offsets, tt_s, perm) -> EmissionOrder:
    """The kept instances in emission order: `order[i]` is the kept
    emission index of sorted instance i, so its inverse maps each emission
    index to its sorted instance. Depth-sorted Gaussian k emitted the
    expansion range [offsets[k], offsets[k] + tt_s[k]); the kept ones
    before a position are an integer cumsum of `keep`. Stable sorts,
    integer sums and scatters to distinct indices only: the same on every
    run."""
    s = order.shape[0]
    inst = torch.empty_like(order)
    inst[order] = torch.arange(s, device=order.device)
    kept_before = torch.cat([keep.new_zeros(1, dtype=torch.int64),
                             torch.cumsum(keep.to(torch.int64), 0)])
    k0 = kept_before[offsets]
    k1 = kept_before[offsets + tt_s]
    start = torch.empty_like(k0)
    count = torch.empty_like(k0)
    start[perm] = k0
    count[perm] = k1 - k0
    return EmissionOrder(inst.to(torch.int32), start.to(torch.int32),
                         count.to(torch.int32))

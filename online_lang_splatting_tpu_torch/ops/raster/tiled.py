"""Tiled blend: the production rasterization path of the port.

Replaces the two Pallas kernels of the JAX package,
`ops/raster/tiled.py:_fwd_kernel` (front-to-back compositing) and
`ops/raster/tiled.py:_bwd_kernel` (its gradient as per-instance rows),
and the XLA scatter-add that summed those rows per Gaussian, with three
CUDA kernels written for Hopper (`csrc/blend_fwd.cu`, `csrc/blend_bwd.cu`,
`csrc/blend_reduce.cu`; their source notes say what bounds them and how
they are laid out). The backward is the JAX form: per-instance rows written
without atomics, then a sum per Gaussian in the binning's emission order
(binning.EmissionOrder), so two runs on the same inputs give the same bits.

Beside each kernel sits its plain PyTorch version: `blend_forward_plain`
and `_backward_rows_plain`, a loop over tiles, vectorised over (instances
× pixels) with `cumprod`, walking each tile's range in chunks and stopping
once every pixel has terminated, and `reduce_rows_plain`, the reduce
kernel's order bit for bit. `blend_backward_plain` (the rows summed by
`index_add_`) is the reference the card's backward is held to. The
wrappers `blend_forward` / `blend_backward` take the plain versions only
for CPU tensors; for CUDA tensors they launch the kernels or raise. They
take the JAX kernels' whole domain: any tile >= 1 and any F_lang. One
launch takes C = F + 4 from kernels.MIN_CHANNELS to kernels.MAX_CHANNELS
(4 to 64); a wider C runs as channel groups (`channel_groups`), one launch
per group in both directions: each group composites its own columns, the
first one alone with `stats`; the backward gives each group its columns'
cotangents and the first one alone g_T (the blend's gradient is linear in
the cotangents), adds the groups' geometry rows in group order and joins
their feature rows.

Inputs of both directions, per Gaussian:
  geom (P, 8) float: x, y, conic a, b, c, opacity, 0, 0
  feat (P, C) float: color (3), language (F), depth (1); C = F + 4
and per render: the sorted instances `s_gid` with per-tile `starts` /
`tile_counts` (ops/raster/binning.py).
Forward outputs: feat_img (C, H, W) accumulated channels, final_t (H, W),
n_contrib (H, W) int32 (1-based last contributing position in the tile's
instance range, 0 = none) and n_touched (P,) int32, which counts only the
pixels of rows py < `py_limit` (default: the height; a band of a frame
split over devices renders rows past the image and counts none of them).
`stats=False` leaves the last two zero. The backward takes the cotangents
of feat_img and final_t and returns per-Gaussian d_geom (P, 6) and d_feat
(P, C).

Images are assembled outside the autograd Function, as in the reference:
color = acc + T·bg, language without bg, opacity = 1 - T, so the gradients
of bg and opacity reach the kernels through final_t.
"""

from __future__ import annotations

import torch

from . import config as C
from .binning import EmissionOrder, bin_gaussians_sorted
from .kernels import MAX_CHANNELS, MIN_CHANNELS, KernelStats
from .oracle import BlendOutput
from .preprocess import Preprocessed

GEOM_COLS = 8


FWD_STATS = KernelStats()
BWD_STATS = KernelStats()
REDUCE_STATS = KernelStats()


def channel_groups(channels: int) -> list[tuple[int, int]]:
    """The feat columns [a, b) that one launch each takes: all of them up
    to MAX_CHANNELS, else ceil(C / MAX_CHANNELS) groups of near-equal width
    (each at least 32, so never below MIN_CHANNELS)."""
    n = max(1, -(-channels // MAX_CHANNELS))
    bounds = [channels * i // n for i in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the card-side reference of chip_smoke.py)


def _tile_pixels(t: int, tiles_x: int, tile: int, width: int, height: int,
                 device):
    lane = torch.arange(tile * tile, device=device)
    px = (t % tiles_x) * tile + lane % tile
    py = (t // tiles_x) * tile + lane // tile
    ok = (px < width) & (py < height)
    return px[ok], py[ok]


PLAIN_CHUNK = 256  # instances per step of the plain versions' tile walk


def _chunk_alpha(g: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                 t_prev: torch.Tensor, done: torch.Tensor):
    """(n, pix) alpha chain of one chunk of a tile's instances, entered
    with per-pixel transmittance `t_prev` and stop flags `done`."""
    x, y = g[:, 0:1], g[:, 1:2]
    ca, cb, cc, op = g[:, 2:3], g[:, 3:4], g[:, 4:5], g[:, 5:6]
    dx = x - px.to(g.dtype)[None, :]
    dy = y - py.to(g.dtype)[None, :]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    expp = torch.exp(power)
    alpha_raw = op * expp
    alpha = torch.clamp(alpha_raw, max=C.ALPHA_MAX)
    skip = (power > 0.0) | (alpha < C.ALPHA_MIN)
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
    one_minus = 1.0 - alpha
    ones = torch.ones_like(one_minus[:1])
    sequential = one_minus.is_cuda
    if sequential:
        # On the card cumprod multiplies down a column in float32, one row
        # after another, so starting the scan at the chunk's entry value
        # gives the kernels' own chain (T <- T (1 - alpha) per row) bit for
        # bit, and the thresholds (T < 1e-4, T > 0.5) count exactly as in
        # the kernels, also in a tile of several chunks. (Scaling the
        # chunk's own product by the entry value afterwards rounds
        # differently.)
        cum_t = torch.cumprod(torch.cat([t_prev[None, :], one_minus[:-1]], 0), 0)
    else:
        # On the CPU cumprod accumulates in float64, so no form repeats the
        # kernels' float32 chain; this one is what the CPU parity tests
        # against the JAX package hold.
        cum_t = t_prev[None, :] * torch.cat([ones, torch.cumprod(one_minus, 0)[:-1]], 0)
    test_t = cum_t * one_minus
    # cum_t is non-increasing down the instance axis (skipped rows multiply
    # by exactly 1), so "a stop fired at or before row i" is test_t < eps.
    stopped = test_t < C.T_EPS
    contrib = ~skip & ~stopped & ~done[None, :]
    w = torch.where(contrib, alpha * cum_t, torch.zeros_like(alpha))
    if sequential:  # T after the last contributing row: its test_t
        t_next = torch.minimum(t_prev, torch.where(
            contrib, test_t, torch.full_like(test_t, float("inf"))).amin(0))
    else:
        t_next = t_prev * torch.prod(torch.where(contrib, one_minus, ones), 0)
    done_next = done | (~skip & stopped).any(0)
    return dict(dx=dx, dy=dy, expp=expp, alpha_raw=alpha_raw, skip=skip,
                one_minus=one_minus, cum_t=cum_t, test_t=test_t,
                contrib=contrib, w=w, t_next=t_next, done_next=done_next)


def _tile_walk(s_gid, starts_h, counts_h, tiles_x, tile, width, height,
               device):
    """Yield (first sorted index, pixel x, pixel y, [(chunk offset, chunk
    ids), ...]) for each non-empty tile: its in-image pixels and its sorted
    instance range cut into PLAIN_CHUNK-sized chunks."""
    for t, n in enumerate(counts_h):
        if n == 0:
            continue
        px, py = _tile_pixels(t, tiles_x, tile, width, height, device)
        ids = s_gid[starts_h[t]:starts_h[t] + n].long()
        yield starts_h[t], px, py, [(c0, ids[c0:c0 + PLAIN_CHUNK])
                                    for c0 in range(0, n, PLAIN_CHUNK)]


def blend_forward_plain(geom, feat, s_gid, starts, tile_counts, *, width: int,
                        height: int, tile: int, stats: bool = True,
                        py_limit: int | None = None):
    device, dtype = feat.device, feat.dtype
    py_limit = height if py_limit is None else py_limit
    p, c = feat.shape
    FWD_STATS.count(c, plain=True)
    tiles_x = (width + tile - 1) // tile
    feat_img = torch.zeros((c, height, width), dtype=dtype, device=device)
    final_t = torch.ones((height, width), dtype=dtype, device=device)
    n_contrib = torch.zeros((height, width), dtype=torch.int32, device=device)
    n_touched = torch.zeros(p, dtype=torch.int32, device=device)
    for _start, px, py, chunks in _tile_walk(s_gid, starts.tolist(), tile_counts.tolist(),
                                             tiles_x, tile, width, height, device):
        t_prev = torch.ones(px.shape[0], dtype=dtype, device=device)
        done = torch.zeros(px.shape[0], dtype=torch.bool, device=device)
        acc = torch.zeros((px.shape[0], c), dtype=dtype, device=device)
        last = torch.zeros(px.shape[0], dtype=torch.int32, device=device)
        for c0, ids in chunks:
            a = _chunk_alpha(geom[ids], px, py, t_prev, done)
            contrib = a["contrib"]
            acc = acc + a["w"].T @ feat[ids]
            if stats:
                pos = torch.arange(c0 + 1, c0 + 1 + ids.shape[0], device=device,
                                   dtype=torch.int32)[:, None]
                last = torch.maximum(last, torch.amax(
                    torch.where(contrib, pos, torch.zeros_like(pos)), 0))
                touched = (contrib & (a["test_t"] > C.N_TOUCHED_T)
                           & (py < py_limit)[None, :]).sum(1)
                n_touched.index_add_(0, ids, touched.to(torch.int32))
            t_prev, done = a["t_next"], a["done_next"]
            if bool(done.all()):
                break  # every pixel terminated: later instances are inert
        feat_img[:, py, px] = acc.T
        final_t[py, px] = t_prev
        n_contrib[py, px] = last
    return feat_img, final_t, n_contrib, n_touched


def _backward_rows_plain(geom, feat, s_gid, starts, tile_counts, g_feat, g_t,
                         feat_img, final_t, *, width: int, height: int,
                         tile: int):
    """Per sorted instance, its 6 + C gradient values summed over its tile's
    pixels: rows (S, 6 + C), the JAX kernel's per-instance dgeom / dfeat.
    The blend walked forward: the suffix sums are the saved per-pixel total
    Σ_f g_f·A_f + g_T·T_final minus the running inclusive prefix of w·G
    (no division by T). Rows past the point where a tile's pixels all
    stopped are zero."""
    device, dtype = feat.device, feat.dtype
    c = feat.shape[1]
    BWD_STATS.count(c, plain=True)
    tiles_x = (width + tile - 1) // tile
    rows = torch.zeros((s_gid.shape[0], 6 + c), dtype=dtype, device=device)
    for start, px, py, chunks in _tile_walk(s_gid, starts.tolist(), tile_counts.tolist(),
                                            tiles_x, tile, width, height, device):
        g_pix = g_feat[:, py, px]                       # (C, pix)
        carry = (g_pix * feat_img[:, py, px]).sum(0) + g_t[py, px] * final_t[py, px]
        t_prev = torch.ones(px.shape[0], dtype=dtype, device=device)
        done = torch.zeros(px.shape[0], dtype=torch.bool, device=device)
        for c0, ids in chunks:
            g = geom[ids]
            a = _chunk_alpha(g, px, py, t_prev, done)
            gdot = feat[ids] @ g_pix                    # (n, pix)
            w = a["w"]
            prefix = torch.cumsum(w * gdot, 0)
            suffix = carry[None, :] - prefix
            carry = carry - prefix[-1]
            dalpha = torch.where(
                a["contrib"], a["cum_t"] * gdot - suffix / a["one_minus"],
                torch.zeros_like(w))
            de = torch.where(a["alpha_raw"] < C.ALPHA_MAX, dalpha * a["expp"],
                             torch.zeros_like(w))
            dpower = de * g[:, 5:6]
            dx, dy = a["dx"], a["dy"]
            ca, cb, cc = g[:, 2:3], g[:, 3:4], g[:, 4:5]
            ddx = dpower * dx
            ddy = dpower * dy
            i0 = start + c0
            rows[i0:i0 + ids.shape[0]] = torch.cat([torch.stack([
                -(ddx * ca + ddy * cb).sum(1),
                -(ddy * cc + ddx * cb).sum(1),
                -0.5 * (ddx * dx).sum(1),
                -(ddx * dy).sum(1),
                -0.5 * (ddy * dy).sum(1),
                de.sum(1),
            ], 1), w @ g_pix.T], 1)
            t_prev, done = a["t_next"], a["done_next"]
            if bool(done.all()):
                break
    return rows


def blend_backward_plain(geom, feat, s_gid, starts, tile_counts, g_feat, g_t,
                         feat_img, final_t, *, width: int, height: int,
                         tile: int):
    """The reference the backward kernels are held to: the plain rows
    summed per Gaussian by `index_add_` (d_geom (P, 6), d_feat (P, C))."""
    p, c = feat.shape
    rows = _backward_rows_plain(geom, feat, s_gid, starts, tile_counts, g_feat, g_t,
                                feat_img, final_t, width=width, height=height,
                                tile=tile)
    table = torch.zeros((p, 6 + c), dtype=feat.dtype, device=feat.device)
    table.index_add_(0, s_gid.long(), rows)
    return table[:, :6], table[:, 6:]


def reduce_rows_plain(rows: torch.Tensor, emission: EmissionOrder,
                      gaussians: int, stored: torch.Tensor) -> torch.Tensor:
    """The reduce kernel's plain version, in its order bit for bit: rows
    (S, K, G) -> d_table (gaussians, G), each instance's stored rows added
    left to right onto +0 (`stored` (S, >= K) uint8 flags of the rows
    kernel), then a Gaussian's instances added in emission order onto
    zero. Unstored rows are never read, so they may hold anything; adding
    them as exact zeros instead gives the same bits."""
    s, k, g = rows.shape
    REDUCE_STATS.count(g - 6, plain=True)
    flags = stored[:, :k].bool()
    inst_rows = torch.zeros((s, g), dtype=rows.dtype, device=rows.device)
    for q in range(k):
        inst_rows = torch.where(flags[:, q, None], inst_rows + rows[:, q], inst_rows)
    table = torch.zeros((gaussians, g), dtype=rows.dtype, device=rows.device)
    start, count = emission.start.long(), emission.count.long()
    inst = emission.inst.long()
    live = torch.nonzero(count > 0).squeeze(1)
    j = 0
    while live.numel():
        table[live] = table[live] + inst_rows[inst[start[live] + j]]
        j += 1
        live = live[count[live] > j]
    return table


def blend_work(geom, feat, s_gid, starts, tile_counts, *, width: int,
               height: int, tile: int) -> tuple[int, int]:
    """(pairs evaluated, pairs contributing) of a render, the work of both
    blend kernels in this data, for their bounds. A pair (instance, in-image
    pixel) has to be evaluated when the pixel has not stopped before it and
    its alpha reaches 1/255: the pairs that composite and each pixel's
    stopping one. The rest lie outside the instance's 1/255 footprint, which
    a kernel can cull per row without evaluating the pair. Counted with the
    same chunk walk as the plain versions."""
    tiles_x = (width + tile - 1) // tile
    evaluated = contributing = 0
    for _start, px, py, chunks in _tile_walk(s_gid, starts.tolist(), tile_counts.tolist(),
                                             tiles_x, tile, width, height, feat.device):
        t_prev = torch.ones(px.shape[0], dtype=feat.dtype, device=feat.device)
        done = torch.zeros(px.shape[0], dtype=torch.bool, device=feat.device)
        for _c0, ids in chunks:
            a = _chunk_alpha(geom[ids], px, py, t_prev, done)
            # Live at row i unless the pixel stopped before it (cum_t[i] is
            # test_t[i - 1]).
            live = ~done[None, :] & ~(a["cum_t"] < C.T_EPS)
            evaluated += int((live & ~a["skip"]).sum())
            contributing += int(a["contrib"].sum())
            t_prev, done = a["t_next"], a["done_next"]
            if bool(done.all()):
                break
    return evaluated, contributing


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the kernel for CUDA tensors


def _check_cuda_inputs(tensors: dict, channels: int, tile: int):
    """The kernels' domain (any tile >= 1; C = F_lang + 4 >= MIN_CHANNELS,
    run in channel groups past MAX_CHANNELS), then each tensor's device,
    type and layout."""
    if channels < MIN_CHANNELS:
        raise ValueError(f"the blend kernels take at least {MIN_CHANNELS} channels "
                         f"(colour, depth), got {channels}")
    if tile < 1:
        raise ValueError(f"the blend kernels take tiles >= 1, got {tile}")
    device = None
    for name, (t, dtype) in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def _forward_group(geom, feat, s_gid, starts, tile_counts, *, width, height,
                   tile, stats, py_limit):
    """One group's forward: the plain version on the CPU, else the kernel."""
    if not feat.is_cuda:
        return blend_forward_plain(geom, feat, s_gid, starts, tile_counts,
                                   width=width, height=height, tile=tile,
                                   stats=stats, py_limit=py_limit)
    from . import kernels

    p, c = feat.shape
    dev = feat.device
    feat_img = torch.empty((c, height, width), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    n_touched = torch.zeros(p, dtype=torch.int32, device=dev)
    kernels.launch_forward(
        geom, feat, s_gid, starts, tile_counts, feat_img, final_t, n_contrib,
        n_touched, channels=c, width=width, height=height, tile=tile,
        stats=stats, py_limit=py_limit)
    FWD_STATS.count(c, plain=False)
    return feat_img, final_t, n_contrib, n_touched


def blend_forward(geom, feat, s_gid, starts, tile_counts, *, width: int,
                  height: int, tile: int, stats: bool = True,
                  py_limit: int | None = None):
    p, c = feat.shape
    if feat.is_cuda:
        _check_cuda_inputs(dict(
            geom=(geom, torch.float32), feat=(feat, torch.float32),
            s_gid=(s_gid, torch.int32), starts=(starts, torch.int32),
            tile_counts=(tile_counts, torch.int32)), c, tile)
        if geom.shape != (p, GEOM_COLS):
            raise ValueError(f"geom must be ({p}, {GEOM_COLS}), got {tuple(geom.shape)}")
    kw = dict(width=width, height=height, tile=tile, py_limit=py_limit)
    outs = [_forward_group(geom, feat[:, a:b].contiguous(), s_gid, starts, tile_counts,
                           stats=stats and i == 0, **kw)
            for i, (a, b) in enumerate(channel_groups(c))]
    feat_img = outs[0][0] if len(outs) == 1 else torch.cat([o[0] for o in outs])
    return (feat_img, *outs[0][1:])


def _backward_group(geom, feat, s_gid, starts, tile_counts, g_feat, g_t,
                    feat_img, final_t, emission, *, width, height, tile):
    """One group's d_table (P, 6 + C): rows, then their sum per Gaussian in
    emission order; the plain versions on the CPU, else the kernels."""
    p, c = feat.shape
    kw = dict(width=width, height=height, tile=tile)
    if not feat.is_cuda:
        rows = _backward_rows_plain(geom, feat, s_gid, starts, tile_counts, g_feat,
                                    g_t, feat_img, final_t, **kw)
        # One row per instance, every one stored.
        return reduce_rows_plain(rows[:, None], emission, p,
                                 torch.ones((rows.shape[0], 1), dtype=torch.uint8))
    from . import kernels

    dev = feat.device
    # The rows need no fill: the reduce reads only those flagged in `stored`.
    k = kernels.ctas_per_tile(tile)
    rows = torch.empty((s_gid.shape[0], k, 6 + c), dtype=torch.float32, device=dev)
    stored = torch.zeros((s_gid.shape[0], kernels.flag_stride(k)), dtype=torch.uint8,
                         device=dev)
    kernels.launch_backward(geom, feat, s_gid, starts, tile_counts, g_feat, g_t,
                            feat_img, final_t, rows, stored, channels=c, **kw)
    BWD_STATS.count(c, plain=False)
    d_table = torch.empty((p, 6 + c), dtype=torch.float32, device=dev)
    kernels.launch_reduce(rows, stored, s_gid, emission.inst, emission.start,
                          emission.count, d_table, channels=c)
    REDUCE_STATS.count(c, plain=False, ctas=k)
    return d_table


def blend_backward(geom, feat, s_gid, starts, tile_counts, g_feat, g_t,
                   feat_img, final_t, *, width: int, height: int, tile: int,
                   emission: EmissionOrder):
    """d_geom (P, 6), d_feat (P, C) of the blend, repeatable bit for bit:
    `emission` is the binning's per-Gaussian order of the instances."""
    p, c = feat.shape
    if feat.is_cuda:
        f32, i32 = torch.float32, torch.int32
        _check_cuda_inputs(dict(
            geom=(geom, f32), feat=(feat, f32), s_gid=(s_gid, i32),
            starts=(starts, i32), tile_counts=(tile_counts, i32),
            g_feat=(g_feat, f32), g_t=(g_t, f32), feat_img=(feat_img, f32),
            final_t=(final_t, f32), emit_inst=(emission.inst, i32),
            emit_start=(emission.start, i32), emit_count=(emission.count, i32)), c, tile)
    kw = dict(width=width, height=height, tile=tile)
    tables = [_backward_group(geom, feat[:, a:b].contiguous(), s_gid, starts, tile_counts,
                              g_feat[a:b], g_t if i == 0 else torch.zeros_like(g_t),
                              feat_img[a:b], final_t, emission, **kw)
              for i, (a, b) in enumerate(channel_groups(c))]
    d_geom = tables[0][:, :6]
    for t in tables[1:]:
        d_geom = d_geom + t[:, :6]
    d_feat = (tables[0][:, 6:] if len(tables) == 1
              else torch.cat([t[:, 6:] for t in tables], 1))
    return d_geom, d_feat


# ---------------------------------------------------------------------------
# Autograd


def pack_inputs(xy, conic, opacity, color, lang, depth):
    """Per-Gaussian kernel inputs: geom (P, 8) and feat (P, C)."""
    pad = torch.zeros((xy.shape[0], GEOM_COLS - 6), dtype=xy.dtype,
                      device=xy.device)
    geom = torch.cat([xy, conic, opacity[:, None], pad], 1).contiguous()
    feat = torch.cat([color, lang, depth[:, None]], 1).contiguous()
    return geom, feat


def blend_inputs(prep: Preprocessed, language_features, *, width: int,
                 height: int, tile: int):
    """(geom, feat, binning) of a render, detached: the exact inputs the
    blend kernels see on the main path."""
    tiles_x = (width + tile - 1) // tile
    tiles_y = (height + tile - 1) // tile
    binning = bin_gaussians_sorted(prep, tiles_x=tiles_x, tiles_y=tiles_y,
                                   tile_px=tile)
    lang = (language_features if language_features is not None
            else prep.xy.new_zeros((prep.xy.shape[0], 0)))
    depth = torch.where(prep.valid, prep.depth, torch.zeros_like(prep.depth))
    geom, feat = pack_inputs(prep.xy, prep.conic, prep.opacity, prep.color,
                             lang, depth)
    return geom.detach(), feat.detach(), binning


class _Blend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xy, conic, opacity, color, lang, depth, s_gid, starts,
                tile_counts, emission, width, height, tile, stats, py_limit=None):
        geom, feat = pack_inputs(xy, conic, opacity, color, lang, depth)
        feat_img, final_t, n_contrib, n_touched = blend_forward(
            geom, feat, s_gid, starts, tile_counts, width=width,
            height=height, tile=tile, stats=stats, py_limit=py_limit)
        ctx.save_for_backward(geom, feat, s_gid, starts, tile_counts,
                              feat_img, final_t)
        ctx.emission = emission
        ctx.meta = (width, height, tile, lang.shape[1])
        ctx.mark_non_differentiable(n_contrib, n_touched)
        return feat_img, final_t, n_contrib, n_touched

    @staticmethod
    def backward(ctx, g_feat, g_t, _g_nc, _g_nt):
        geom, feat, s_gid, starts, tile_counts, feat_img, final_t = ctx.saved_tensors
        width, height, tile, f_lang = ctx.meta
        g_feat = torch.zeros_like(feat_img) if g_feat is None else g_feat.contiguous()
        g_t = torch.zeros_like(final_t) if g_t is None else g_t.contiguous()
        d_geom, d_feat = blend_backward(
            geom, feat, s_gid, starts, tile_counts, g_feat, g_t, feat_img,
            final_t, width=width, height=height, tile=tile, emission=ctx.emission)
        return (d_geom[:, 0:2], d_geom[:, 2:5], d_geom[:, 5], d_feat[:, 0:3],
                d_feat[:, 3:3 + f_lang], d_feat[:, 3 + f_lang],
                None, None, None, None, None, None, None, None, None)


def blend_tiled(prep: Preprocessed, language_features, bg, *, width: int,
                height: int, tile: int = C.DEFAULT_TILE,
                stats: bool = True, py_limit: int | None = None) -> BlendOutput:
    """Bin → blend kernels → image assembly. Same outputs as the oracle.
    `py_limit` (default `height`) bounds the rows n_touched counts; the
    backward does not read it."""
    p = prep.xy.shape[0]
    tiles_x = (width + tile - 1) // tile
    tiles_y = (height + tile - 1) // tile
    binning = bin_gaussians_sorted(prep, tiles_x=tiles_x, tiles_y=tiles_y,
                                   tile_px=tile)
    lang = (language_features if language_features is not None
            else prep.xy.new_zeros((p, 0)))
    f_lang = lang.shape[1]
    depth = torch.where(prep.valid, prep.depth, torch.zeros_like(prep.depth))
    feat_img, final_t, n_contrib, n_touched = _Blend.apply(
        prep.xy, prep.conic, prep.opacity, prep.color, lang, depth,
        binning.s_gid, binning.starts, binning.tile_counts, binning.emission,
        width, height, tile, stats, py_limit)
    return BlendOutput(
        color=feat_img[0:3] + final_t[None] * bg[:, None, None],
        language=feat_img[3:3 + f_lang],
        depth=feat_img[3 + f_lang:4 + f_lang],
        opacity=(1.0 - final_t)[None],
        final_t=final_t,
        n_contrib=n_contrib,
        n_touched=n_touched,
        num_instances=binning.num_instances,
        overflow=False,
    )

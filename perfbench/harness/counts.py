"""The yardstick's arithmetic: the card's peaks, the blend kernels' bytes
and operations, a frozen copy of the count of (instance, pixel) pairs a
render needs, and the extractor's operations from its published shapes."""

from __future__ import annotations

import torch

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): float32
# outside the tensor cores (the port runs float32 with TF32 off), and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Operations per (instance, pixel) pair, counted from the blend kernels'
# sources: every pair that must be evaluated (alpha reaches 1/255 at a
# live pixel) 15 (offset, power, exp, alpha, tests); every pair that
# composites 2C + 3 more in the forward (T update, weight, C multiply-adds)
# and 4C + 31 more in the backward (dot product, suffix, C feature-gradient
# products, the geometry chain, one add per value into the per-Gaussian sum).
FLOPS_EVAL = 15
GEOM_COLS = 8
ALPHA_MAX, ALPHA_MIN, T_EPS = 0.99, 1.0 / 255.0, 1e-4


def blend_bytes(kind: str, p: int, n: int, c: int, h: int, w: int, tile: int) -> int:
    """Bytes one blend call must move: each input read once and each output
    written once. Rows of the per-Gaussian tables count once per Gaussian
    an instance can name (at most min(P, instances)); the backward is the
    rows kernel and the reduce together, so its per-instance rows are an
    intermediate, and it writes all P rows of d_table (a scatter-add into
    zeros does)."""
    tiles = (-(-w // tile)) * (-(-h // tile))
    rows = min(p, n) * (GEOM_COLS + c) * 4
    binning = n * 4 + 2 * tiles * 4
    hw = h * w * 4
    if kind == "fwd":
        return rows + binning + (c + 2) * hw + p * 4
    # g_feat, feat_img (C each), g_T, final_T; emission order; d_table.
    return rows + binning + (2 * c + 2) * hw + n * 4 + 2 * p * 4 + p * (6 + c) * 4


def blend_flops(kind: str, c: int, evaluated: float, contributing: float) -> float:
    extra = 2 * c + 3 if kind == "fwd" else 4 * c + 31
    return FLOPS_EVAL * evaluated + extra * contributing


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the float32
    peak or bytes over the memory rate, whichever is larger."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


@torch.no_grad()
def blend_work(geom, s_gid, starts, tile_counts, *, width: int, height: int,
               tile: int, chunk: int = 256) -> tuple[int, int]:
    """(pairs evaluated, pairs contributing) of one render's blend inputs:
    geom (P, 8) rows x, y, conic a, b, c, opacity; the sorted instances
    and each tile's range. A pair (instance, in-image pixel) is evaluated
    when the pixel has not stopped before it and its alpha reaches 1/255;
    it contributes when it composites."""
    tiles_x = -(-width // tile)
    dev = geom.device
    lane = torch.arange(tile * tile, device=dev)
    evaluated = contributing = 0
    for t, (s0, n) in enumerate(zip(starts.tolist(), tile_counts.tolist())):
        if n == 0:
            continue
        px = (t % tiles_x) * tile + lane % tile
        py = (t // tiles_x) * tile + lane // tile
        ok = (px < width) & (py < height)
        px, py = px[ok].float(), py[ok].float()
        ids = s_gid[s0:s0 + n].long()
        t_prev = torch.ones(px.numel(), device=dev)
        done = torch.zeros(px.numel(), dtype=torch.bool, device=dev)
        for c0 in range(0, n, chunk):
            g = geom[ids[c0:c0 + chunk]]
            dx, dy = g[:, 0:1] - px[None], g[:, 1:2] - py[None]
            power = -0.5 * (g[:, 2:3] * dx * dx + g[:, 4:5] * dy * dy) - g[:, 3:4] * dx * dy
            alpha = torch.clamp(g[:, 5:6] * torch.exp(power), max=ALPHA_MAX)
            skip = (power > 0.0) | (alpha < ALPHA_MIN)
            alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
            om = 1.0 - alpha
            before = torch.cumprod(torch.cat([t_prev[None], om[:-1]], 0), 0)
            after = before * om
            live = ~done[None] & ~(before < T_EPS)
            contrib = ~skip & ~(after < T_EPS) & ~done[None]
            evaluated += int((live & ~skip).sum())
            contributing += int(contrib.sum())
            t_prev = torch.minimum(t_prev, torch.where(
                contrib, after, torch.full_like(after, float("inf"))).amin(0))
            done = done | (~skip & (after < T_EPS)).any(0)
            if bool(done.all()):
                break
    return evaluated, contributing


def extractor_flops(cfg: dict) -> float:
    """Operations of one `encode_frame` at the configuration's shapes: two
    per multiply-add of every convolution and linear layer (tower, HR head,
    AE encoder). Norms, activations and resizes are not counted."""
    s = cfg["clip_resolution"][0]
    depths, dims, embed = cfg["depths"], cfg["dims"], cfg["embed_dim"]
    macs = 0
    h = s // 4
    macs += h * h * dims[0] * 3 * 16                                  # stem 4x4 / 4
    for i, (depth, d) in enumerate(zip(depths, dims)):
        if i > 0:
            h //= 2
            macs += h * h * d * dims[i - 1] * 4                       # downsample 2x2 / 2
        macs += depth * h * h * (d * 49 + 2 * d * 4 * d)              # dw 7x7, MLP 4x
    macs += h * h * (dims[-1] * 2 * embed + 2 * embed * embed)        # per-location head
    g = h                                                             # os32 grid

    def conv(hh, cout, cin, k):
        return hh * hh * cout * cin * k * k

    def fusion(hh, c, low):
        return ((conv(hh, c, low, 1) if low != c else 0) + conv(hh, c, 2 * c, 3)
                + conv(hh, c, c, 3) + conv(hh, c, c, 1))

    # HR head; a stride-2 4x4 transposed convolution feeds 2x2 taps per output.
    macs += conv(g, 512, embed, 3) + conv(2 * g, 512, 512, 2) + fusion(2 * g, 512, dims[1])
    macs += conv(4 * g, 256, 512, 2) + fusion(4 * g, 256, dims[0])
    macs += conv(8 * g, 128, 256, 2) + conv(8 * g, cfg["clip_dim"], 128, 1)
    d_in, pix = cfg["clip_dim"], (8 * g) ** 2
    for d in cfg["ae_encoder"]:
        macs += pix * d_in * d
        d_in = d
    return 2.0 * macs

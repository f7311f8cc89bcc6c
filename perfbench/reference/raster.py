"""Plain reference of the Gaussian-splat render: EWA projection of 3D
Gaussians (Kerbl et al., "3D Gaussian Splatting", SIGGRAPH 2023) and
front-to-back alpha compositing per pixel, as functional PyTorch,
float32, written from the published method and not from the program.

It takes the map's raw parameters (log scales, opacity logits,
unnormalized quaternions, SH degree-0 colours, language features) and a
world-to-camera pose, and gives colour, language and depth images and the
final transmittance. The rules of the compositing are the method's:
alpha = min(0.99, opacity * exp(power)), a pair is skipped where power > 0
or alpha < 1/255, a pixel stops before the Gaussian that would bring its
transmittance below 1e-4, a Gaussian reaches only the tiles of its
3-sigma box, and Gaussians nearer than 0.2 are culled. Pixels are walked
tile by tile with the Gaussians of a tile in depth order, in chunks that
carry each pixel's transmittance.
"""

from __future__ import annotations

import math

import torch

ALPHA_MAX, ALPHA_MIN, T_EPS, NEAR, LOWPASS = 0.99, 1.0 / 255.0, 1e-4, 0.2, 0.3
SH_C0 = 0.28209479177387814
CHUNK = 2048


def _activate(params: dict):
    """Activated per-Gaussian values of the live Gaussians."""
    live = params["active"].bool()
    xyz = params["xyz"][live].float()
    opacity = torch.sigmoid(params["opacity"][live, 0].float())
    scales = torch.exp(params["scaling"][live].float())
    q = params["rotation"][live].float()
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    color = torch.clamp(SH_C0 * params["features_dc"][live, 0].float() + 0.5, min=0.0)
    lang = params["language"][live].float()
    return xyz, opacity, scales, q, color, lang


def _rotation(q):
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def project(params: dict, w2c: torch.Tensor, fx, fy, cx, cy, width, height, tile):
    """Screen-space Gaussians: pixel mean, conic, opacity, colour,
    language, view depth and the inclusive / exclusive tile box."""
    xyz, opacity, scales, q, color, lang = _activate(params)
    rot_w, t_w = w2c[:3, :3], w2c[:3, 3]
    p = (xyz[:, :, None] * rot_w.T[None]).sum(1) + t_w
    z = p[:, 2]
    front = z > NEAR
    zs = torch.where(front, z, torch.ones_like(z))
    px = fx * p[:, 0] / zs + cx - 0.5
    py = fy * p[:, 1] / zs + cy - 0.5
    # EWA: the Jacobian of the projection at the mean, its x / z and y / z
    # held to 1.3 times the half field of view.
    limx, limy = 1.3 * width / (2.0 * fx), 1.3 * height / (2.0 * fy)
    tx = torch.clamp(p[:, 0] / zs, -limx, limx) * zs
    ty = torch.clamp(p[:, 1] / zs, -limy, limy) * zs
    zero = torch.zeros_like(zs)
    jac = torch.stack([torch.stack([fx / zs, zero, -fx * tx / (zs * zs)], -1),
                       torch.stack([zero, fy / zs, -fy * ty / (zs * zs)], -1)], -2)
    rot = _rotation(q)
    m = rot * torch.square(scales)[:, None, :]
    cov3 = (m[:, :, None, :] * rot[:, None, :, :]).sum(-1)           # R S^2 R^T
    tmat = (jac[:, :, :, None] * rot_w[None, None]).sum(2)           # J W
    cov2 = (tmat[:, :, None, :, None] * cov3[:, None, None] * tmat[:, None, :, None, :]
            ).sum((-1, -2))
    a, b, c = cov2[:, 0, 0] + LOWPASS, cov2[:, 0, 1], cov2[:, 1, 1] + LOWPASS
    det = a * c - b * b
    det_ok = det != 0.0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc, mid - disc)))
    tiles_x, tiles_y = -(-width // tile), -(-height // tile)

    def tile_of(v, hi):
        return torch.clamp((v / tile).to(torch.int32), 0, hi)

    box = torch.stack([tile_of(px - radius, tiles_x), tile_of(py - radius, tiles_y),
                       tile_of(px + radius + tile - 1, tiles_x),
                       tile_of(py + radius + tile - 1, tiles_y)], -1)
    area = (box[:, 2] - box[:, 0]).clamp(min=0) * (box[:, 3] - box[:, 1]).clamp(min=0)
    keep = front & det_ok & (area > 0)
    feat = torch.cat([color, lang, z[:, None]], 1)
    return dict(xy=torch.stack([px, py], -1)[keep], conic=conic[keep], opacity=opacity[keep],
                feat=feat[keep], depth=z[keep], box=box[keep], tiles_x=tiles_x,
                tiles_y=tiles_y)


def tiles(g: dict, width: int, height: int, tile: int):
    """Each tile that some Gaussian reaches: (its Gaussians in depth
    order, its in-image pixels' x and y)."""
    dev = g["xy"].device
    box, tiles_x = g["box"], g["tiles_x"]
    # Every (Gaussian, tile) pair of the boxes, in depth order within a tile.
    order = torch.argsort(g["depth"], stable=True)
    box = box[order]
    w_box = (box[:, 2] - box[:, 0]).long()
    counts = w_box * (box[:, 3] - box[:, 1]).long()
    gid = torch.repeat_interleave(order, counts)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    k = torch.arange(gid.numel(), device=dev) - first
    wb = torch.repeat_interleave(w_box, counts)
    bx = torch.repeat_interleave(box[:, 0].long(), counts) + k % wb
    by = torch.repeat_interleave(box[:, 1].long(), counts) + k // wb
    tile_id = by * tiles_x + bx
    srt = torch.argsort(tile_id, stable=True)
    gid, tile_id = gid[srt], tile_id[srt]
    n_tiles = tiles_x * g["tiles_y"]
    per_tile = torch.bincount(tile_id, minlength=n_tiles).tolist()
    lane = torch.arange(tile * tile, device=dev)
    start = 0
    for t, n in enumerate(per_tile):
        if n == 0:
            continue
        ids = gid[start:start + n]
        start += n
        xs = (t % tiles_x) * tile + lane % tile
        ys = (t // tiles_x) * tile + lane // tile
        inside = (xs < width) & (ys < height)
        yield ids, xs[inside], ys[inside]


def composite(g: dict, ids, xs, ys):
    """Front-to-back compositing of the Gaussians `ids` (depth order) over
    the pixels (xs, ys): the features (pix, F) and final transmittance
    (pix). Differentiable in g's xy, conic, opacity and feat."""
    dev = g["xy"].device
    t_cur = torch.ones(xs.numel(), dtype=torch.float32, device=dev)
    done = torch.zeros(xs.numel(), dtype=torch.bool, device=dev)
    acc = torch.zeros((xs.numel(), g["feat"].shape[1]), dtype=torch.float32, device=dev)
    for c0 in range(0, ids.numel(), CHUNK):
        cid = ids[c0:c0 + CHUNK]
        dx = g["xy"][cid, 0:1] - xs[None].float()
        dy = g["xy"][cid, 1:2] - ys[None].float()
        ca, cb, cc = g["conic"][cid].unbind(-1)
        power = -0.5 * (ca[:, None] * dx * dx + cc[:, None] * dy * dy) - cb[:, None] * dx * dy
        alpha = torch.clamp(g["opacity"][cid, None] * torch.exp(power), max=ALPHA_MAX)
        skip = (power > 0.0) | (alpha < ALPHA_MIN)
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
        om = 1.0 - alpha
        # Transmittance before each Gaussian, one multiply per row.
        before = torch.cumprod(torch.cat([t_cur[None], om[:-1]], 0), 0)
        after = before * om
        contrib = ~skip & ~(after < T_EPS) & ~done[None]
        w = torch.where(contrib, alpha * before, torch.zeros_like(alpha))
        acc = acc + w.T @ g["feat"][cid]
        t_cur = torch.minimum(t_cur, torch.where(
            contrib, after, torch.full_like(after, math.inf)).amin(0))
        done = done | (~skip & (after < T_EPS)).any(0)
        if bool(done.all()):
            break
    return acc, t_cur


@torch.no_grad()
def render(params: dict, w2c: torch.Tensor, *, fx: float, fy: float, cx: float, cy: float,
           width: int, height: int, tile: int = 32) -> dict:
    """colour (3, H, W) on a black background, language (F, H, W), depth
    (1, H, W) and final transmittance (H, W) of the map seen from `w2c`."""
    g = project(params, w2c.float(), fx, fy, cx, cy, width, height, tile)
    dev = g["xy"].device
    n_feat = g["feat"].shape[1]
    out = torch.zeros((n_feat, height, width), dtype=torch.float32, device=dev)
    final_t = torch.ones((height, width), dtype=torch.float32, device=dev)
    for ids, xs, ys in tiles(g, width, height, tile):
        acc, t_cur = composite(g, ids, xs, ys)
        out[:, ys, xs] = acc.T
        final_t[ys, xs] = t_cur
    return dict(color=out[0:3], language=out[3:n_feat - 1], depth=out[n_feat - 1:],
                final_t=final_t)

"""Plain reference of one mapping iteration's Gaussian update, as
functional PyTorch in float32, written from the published method and not
from the program: the RGB-D mapping loss of MonoGS (Matsuki et al.,
"Gaussian Splatting SLAM", CVPR 2024) with the language L1 of Online
Language Splatting, summed over the keyframe slots, differentiated through
`raster.py`'s render; the 10x isotropic scale regulariser; and a masked
Adam step (Kingma and Ba, 2015) with eps 1e-15, as 3D Gaussian Splatting
takes it.

The loss is a mean of per-pixel terms, so each tile's share is
differentiated by itself, down to the projected Gaussians, and the sums
are carried back through the projection once: the memory of one tile at
a time."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.raster import composite, project, tiles

LEAVES = ("xyz", "features_dc", "scaling", "rotation", "opacity", "language")
PROJECTED = ("xy", "conic", "opacity", "feat")


def _abs(x):
    """|x| with slope +1 at 0, as the L1 of the method's JAX code
    differentiates it."""
    return torch.where(x >= 0, x, -x)


def slot_grads(params: dict, active, w2c, image, depth, lang, *, lang_on: bool, ea, eb,
               lang_weight: float, init_mode: bool, fx, fy, cx, cy, width: int, height: int,
               tile: int, alpha: float = 0.95, rgb_boundary: float = 0.01) -> dict:
    """The gradient of one slot's mapping loss in each leaf of LEAVES.
    image (3, H, W) and depth (1, H, W) are the keyframe's frames, lang
    (F, h, w) its language supervision."""
    leaves = {k: params[k].detach().float().requires_grad_(True) for k in LEAVES}
    g = project(dict(leaves, active=active), w2c.float(), fx, fy, cx, cy, width, height, tile)
    cut = {k: g[k].detach().requires_grad_(True) for k in PROJECTED}
    walk = dict(g, **cut)
    sums = {k: torch.zeros_like(cut[k]) for k in PROJECTED}
    n_pix = float(height * width)
    rgb_mask = image.sum(0) > rgb_boundary
    depth_mask = depth[0] > 0.01
    lang_hw = None
    if lang_on:
        lang_hw = lang if tuple(lang.shape[1:]) == (height, width) else F.interpolate(
            lang[None], size=(height, width), mode="bilinear", align_corners=False,
            antialias=False)[0]
    for ids, xs, ys in tiles(g, width, height, tile):
        acc, _ = composite(walk, ids, xs, ys)
        color = acc[:, 0:3]
        if not init_mode:
            color = torch.exp(ea) * color + eb
        m = rgb_mask[ys, xs][:, None]
        loss = alpha * _abs(color * m - image[:, ys, xs].T * m).sum() / (3.0 * n_pix)
        dm = depth_mask[ys, xs]
        loss = loss + (1.0 - alpha) * _abs(acc[:, -1] * dm - depth[0, ys, xs] * dm).sum() / n_pix
        if lang_on:
            f = lang_hw.shape[0]
            loss = loss + lang_weight * _abs(acc[:, 3:-1] - lang_hw[:, ys, xs].T).sum() / (
                f * n_pix)
        for k, d in zip(PROJECTED, torch.autograd.grad(loss, [cut[k] for k in PROJECTED],
                                                       allow_unused=True)):
            if d is not None:
                sums[k] += d
    torch.autograd.backward([g[k] for k in PROJECTED], [sums[k] for k in PROJECTED])
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in leaves.items()}


def isotropic_grad(scaling, active):
    """The gradient of 10 x the mean over live Gaussians of
    |s - mean(s)| of the activated scales s."""
    s = scaling.detach().float().requires_grad_(True)
    e = torch.exp(s)
    w = active.float()[:, None]
    iso = 10.0 * (_abs(e - e.mean(1, keepdim=True)) * w).sum() / torch.clamp(w.sum() * 3.0,
                                                                              min=1.0)
    return torch.autograd.grad(iso, [s])[0]


def adam(params: dict, grads: dict, mu: dict, nu: dict, count, lrs: dict, active,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15) -> dict:
    """One Adam step of every leaf, live Gaussians only."""
    n = count.float() + 1.0
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=n.device), n)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=n.device), n)
    out = {}
    for k, p in params.items():
        live = active.reshape((-1,) + (1,) * (p.dim() - 1))
        g = torch.where(live, grads[k], torch.zeros_like(grads[k]))
        m = b1 * mu[k] + (1.0 - b1) * g
        v = b2 * nu[k] + (1.0 - b2) * g * g
        out[k] = torch.where(live, p - lrs[k] * (m / c1) / (torch.sqrt(v / c2) + eps), p)
    return out

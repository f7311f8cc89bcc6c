"""The golden rasterizer scenes, built with numpy only.

Same scenes, seeds and draw order as the JAX package's test fixtures
(`tests/raster_fixtures.py`), whose pinned outputs live in `tests/goldens/`
(tile 16) and `tests/goldens_t32/` (tile 32). Kept free of JAX so the port's
tests and `chip_smoke.py` can replay the goldens on a machine without JAX.

  alpha_clamp     opacity -> 1 tight splats: the 0.99 clamp engages
  t_cutoff        dense opaque stack: the T < 1e-4 stop fires mid-list
  many_contrib    > 256 overlapping contributors per pixel
  huge_splats     multi-tile splats mixed with sub-tile ones
  degenerate_cov  near-zero and near-flat scales
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import graphics

GOLDEN_DIRS = {16: "goldens", 32: "goldens_t32"}
INT_KEYS = ("radii", "n_touched", "n_contrib")
GRAD_KEYS = ("d_means", "d_scales", "d_opac", "d_lang")
BG = np.asarray([0.15, 0.25, 0.35], np.float32)


def make_camera(width=64, height=48, fx=60.0, fy=60.0, znear=0.01, zfar=100.0):
    """(view (4,4), proj (4,4), tanfovx, tanfovy) as float32 numpy."""
    cx, cy = width / 2.0, height / 2.0
    proj = graphics.projection_matrix(znear, zfar, cx, cy, fx, fy, width,
                                      height).numpy()
    return np.eye(4, dtype=np.float32), proj, width / (2.0 * fx), height / (2.0 * fy)


def _pack(means, scales, quats, opac, shs, lang, width, height):
    view, proj, tanfovx, tanfovy = make_camera(width, height)
    return dict(
        means3d=np.asarray(means, np.float32),
        scales=np.asarray(scales, np.float32),
        quats=np.asarray(quats, np.float32),
        opacities=np.asarray(opac, np.float32),
        shs=np.asarray(shs, np.float32),
        language_features=np.asarray(lang, np.float32),
        viewmatrix=view, projmatrix=proj, width=width, height=height,
        tanfovx=float(tanfovx), tanfovy=float(tanfovy),
    )


def _base(rng, n, depth_range=(2.0, 6.0), spread=0.9, hw=(48, 64)):
    h, w = hw
    means = np.zeros((n, 3), np.float32)
    means[:, 0] = rng.uniform(-spread, spread, n)
    means[:, 1] = rng.uniform(-spread * h / w, spread * h / w, n)
    means[:, 2] = rng.uniform(*depth_range, n)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    shs = rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3
    lang = rng.normal(size=(n, 15)).astype(np.float32)
    return means, q, shs, lang


def scene_alpha_clamp():
    rng = np.random.default_rng(11)
    n = 48
    means, q, shs, lang = _base(rng, n)
    scales = rng.uniform(0.15, 0.4, (n, 3)).astype(np.float32)
    opac = np.full((n,), 0.999, np.float32)
    return _pack(means, scales, q, opac, shs, lang, 64, 48)


def scene_t_cutoff():
    rng = np.random.default_rng(12)
    n = 160
    means, q, shs, lang = _base(rng, n, spread=0.35, depth_range=(2.0, 2.6))
    scales = rng.uniform(0.2, 0.5, (n, 3)).astype(np.float32)
    opac = np.full((n,), 0.98, np.float32)
    return _pack(means, scales, q, opac, shs, lang, 48, 48)


def scene_many_contrib():
    rng = np.random.default_rng(13)
    n = 400
    means, q, shs, lang = _base(rng, n, spread=0.25, depth_range=(2.0, 8.0))
    scales = rng.uniform(0.3, 0.8, (n, 3)).astype(np.float32)
    opac = np.full((n,), 0.03, np.float32)
    return _pack(means, scales, q, opac, shs, lang, 32, 32)


def scene_huge_splats():
    rng = np.random.default_rng(14)
    n = 40
    means, q, shs, lang = _base(rng, n)
    scales = np.concatenate([
        rng.uniform(1.5, 3.0, (8, 3)),
        rng.uniform(0.01, 0.05, (n - 8, 3)),
    ]).astype(np.float32)
    opac = rng.uniform(0.4, 0.9, n).astype(np.float32)
    return _pack(means, scales, q, opac, shs, lang, 80, 48)


def scene_degenerate_cov():
    rng = np.random.default_rng(15)
    n = 64
    means, q, shs, lang = _base(rng, n)
    scales = np.stack([
        rng.uniform(1e-5, 1e-3, n),
        rng.uniform(0.2, 0.6, n),
        rng.uniform(1e-4, 1e-2, n),
    ], axis=1).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    return _pack(means, scales, q, opac, shs, lang, 64, 48)


SCENES = {
    "alpha_clamp": scene_alpha_clamp,
    "t_cutoff": scene_t_cutoff,
    "many_contrib": scene_many_contrib,
    "huge_splats": scene_huge_splats,
    "degenerate_cov": scene_degenerate_cov,
}


def load_golden(repo_root, name: str, tile: int) -> dict:
    path = Path(repo_root) / "tests" / GOLDEN_DIRS[tile] / f"{name}.npz"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def render_scene(scene: dict, backend: str, *, tile: int, device="cpu",
                 lang: bool = True, stats: bool = True) -> dict:
    """Forward outputs + gradients of the goldens' weighted loss, through
    the port's `rasterize`. `lang=False` renders with F_lang = 0 (the
    tracking shape); its language output and gradient are then empty."""
    from .api import RasterSettings, rasterize

    def t(a):
        return torch.as_tensor(a, device=device)

    settings = RasterSettings(
        image_height=scene["height"], image_width=scene["width"],
        tanfovx=scene["tanfovx"], tanfovy=scene["tanfovy"], sh_degree=0,
        tile=tile, backend=backend, stats=stats,
    )
    means = t(scene["means3d"]).requires_grad_(True)
    scales = t(scene["scales"]).requires_grad_(True)
    opac = t(scene["opacities"]).requires_grad_(True)
    lang_in = t(scene["language_features"])
    if not lang:
        lang_in = lang_in[:, :0]
    lang_in = lang_in.clone().requires_grad_(True)
    out = rasterize(
        means, opac, scales, t(scene["quats"]), shs=t(scene["shs"]),
        language_features=lang_in, viewmatrix=t(scene["viewmatrix"]),
        projmatrix=t(scene["projmatrix"]), settings=settings, bg=t(BG),
    )
    h, w = out.color.shape[1:]
    wgt = ((torch.arange(h * w, dtype=torch.float32, device=device)
            .reshape(1, h, w) % 7) - 3.0) / 7.0
    loss = (torch.sum(out.color * wgt) + 0.5 * torch.sum(out.language * wgt)
            + 2.0 * torch.sum(out.depth * wgt) + torch.sum(out.opacity * wgt))
    loss.backward()

    def n(a):
        return a.detach().cpu().numpy()

    return {
        "color": n(out.color), "language": n(out.language),
        "depth": n(out.depth), "opacity": n(out.opacity),
        "final_t": n(out.final_t), "radii": n(out.radii),
        "n_touched": n(out.n_touched), "n_contrib": n(out.n_contrib),
        "d_means": n(means.grad), "d_scales": n(scales.grad),
        "d_opac": n(opac.grad), "d_lang": n(lang_in.grad),
    }


def max_normalized_error(got: dict, ref: dict) -> dict:
    """Per key: max |got - ref| / max(|ref|max, 1) for floats, the count of
    differing entries for ints (the goldens' comparison)."""
    errs = {}
    for key, r in ref.items():
        g = got[key]
        if g.shape != r.shape:
            raise ValueError(f"{key}: shape {g.shape} vs {r.shape}")
        if key in INT_KEYS:
            errs[key] = int(np.count_nonzero(g != r))
        elif r.size == 0:
            errs[key] = 0.0
        else:
            scale = max(float(np.abs(r).max()), 1.0)
            errs[key] = float(np.abs(g - r).max() / scale)
    return errs

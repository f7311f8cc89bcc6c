"""Port parity of the rasterizer: preprocess, binning, the blend (plain
PyTorch versions of the CUDA kernels, the CPU path), the goldens and an
f64 gradcheck of the blend's autograd Function.

Tolerances (normalized = max |a - b| / max(|ref|, 1)):
  preprocess    floats rtol 1e-5, ints exact
  binning       exact
  blend         forward 1e-4 normalized, ints exact, gradients 2e-3
                normalized (the goldens' tiled tolerances:
                tests/test_raster_goldens.py)
  goldens       oracle forward 1e-5 and gradients 5e-5 (autodiff through
                degenerate_cov's ~1e3 scale anisotropy in another
                framework's operation order measures 2.1e-5); tiled path
                1e-4 / 2e-3; ints exact
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import assert_normalized, n, t

import raster_fixtures
from online_lang_splatting_tpu.ops import lie as jlie
from online_lang_splatting_tpu.ops.raster import binning as jbinning
from online_lang_splatting_tpu.ops.raster import preprocess as jpre
from online_lang_splatting_tpu.ops.raster.oracle import blend_oracle as jblend_oracle
from online_lang_splatting_tpu.ops.raster.tiled import blend_tiled as jblend_tiled
from online_lang_splatting_tpu_torch.ops.raster import api, binning, scenes, tiled
from online_lang_splatting_tpu_torch.ops.raster.oracle import blend_oracle
from online_lang_splatting_tpu_torch.ops.raster.preprocess import Preprocessed

REPO = Path(__file__).resolve().parent.parent
INT_FIELDS = ("valid", "radius", "rect_min", "rect_max", "tiles_touched")
FLOAT_FIELDS = ("xy", "depth", "conic", "opacity", "color")

# (name, n, width, height, tile, seed): a tile-16 scene, a ragged one (the
# image edge cuts tiles) and a tile-32 one.
SCENES = [
    ("t16", 60, 64, 48, 16, 0),
    ("ragged", 50, 50, 34, 16, 1),
    ("t32", 70, 64, 64, 32, 2),
]


def _scene(n_g, width, height, seed, sh_degree=1):
    rng = np.random.default_rng(seed)
    means = np.zeros((n_g, 3), np.float32)
    means[:, 0] = rng.uniform(-1.0, 1.0, n_g)
    means[:, 1] = rng.uniform(-height / width, height / width, n_g)
    means[:, 2] = rng.uniform(2.0, 6.0, n_g)
    q = rng.normal(size=(n_g, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    view, proj, tanfovx, tanfovy = scenes.make_camera(width, height)
    return dict(
        means3d=means, scales=rng.uniform(0.05, 0.3, (n_g, 3)).astype(np.float32),
        quats=q, opacities=rng.uniform(0.3, 0.95, n_g).astype(np.float32),
        shs=(rng.normal(size=(n_g, (sh_degree + 1) ** 2, 3)) * 0.3).astype(np.float32),
        lang=rng.normal(size=(n_g, 15)).astype(np.float32),
        view=view, proj=proj, tanfovx=tanfovx, tanfovy=tanfovy,
        width=width, height=height, sh_degree=sh_degree,
        tau=(rng.normal(size=6) * 0.01).astype(np.float32),
    )


def _jax_prep(sc, tile, means=None, scales=None, quats=None, opac=None, shs=None, tau=None):
    """The JAX package's rasterize() preprocess stage (api.py:148-170)."""
    means = jnp.asarray(sc["means3d"]) if means is None else means
    tau = jnp.asarray(sc["tau"]) if tau is None else tau
    view = jlie.se3_exp(tau) @ jnp.asarray(sc["view"])
    full = jnp.asarray(sc["proj"]) @ view
    w2c0 = jax.lax.stop_gradient(view)
    campos = -w2c0[:3, :3].T @ w2c0[:3, 3]
    return jpre.preprocess(
        means, jnp.asarray(sc["scales"]) if scales is None else scales,
        jnp.asarray(sc["quats"]) if quats is None else quats,
        jnp.asarray(sc["opacities"]) if opac is None else opac,
        view, full, campos,
        shs=jnp.asarray(sc["shs"]) if shs is None else shs,
        sh_degree=sc["sh_degree"], width=sc["width"], height=sc["height"],
        tan_fovx=sc["tanfovx"], tan_fovy=sc["tanfovy"], tile=tile)


def _settings(sc, tile, backend="cuda"):
    return api.RasterSettings(
        image_height=sc["height"], image_width=sc["width"], tanfovx=sc["tanfovx"],
        tanfovy=sc["tanfovy"], sh_degree=sc["sh_degree"], tile=tile, backend=backend)


def _torch_prep(sc, tile, **leaves):
    tau = leaves.get("tau", t(sc["tau"]))
    return api.project(
        leaves.get("means", t(sc["means3d"])), leaves.get("opac", t(sc["opacities"])),
        leaves.get("scales", t(sc["scales"])), leaves.get("quats", t(sc["quats"])),
        viewmatrix=t(sc["view"]), projmatrix=t(sc["proj"]), settings=_settings(sc, tile),
        shs=leaves.get("shs", t(sc["shs"])), cam_trans_delta=tau[:3], cam_rot_delta=tau[3:])


def _prep_to_torch(prep) -> Preprocessed:
    return Preprocessed(*(t(x) for x in prep))


@pytest.mark.parametrize("name,n_g,width,height,tile,seed", SCENES)
def test_preprocess_fields_and_grads(name, n_g, width, height, tile, seed):
    sc = _scene(n_g, width, height, seed)
    ref = jax.jit(lambda: _jax_prep(sc, tile))()
    got = _torch_prep(sc, tile)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(n(getattr(got, f)), n(getattr(ref, f)), err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(n(getattr(got, f)), n(getattr(ref, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)

    rng = np.random.default_rng(seed + 10)
    wts = {f: rng.normal(size=np.shape(getattr(ref, f))).astype(np.float32)
           for f in ("xy", "depth", "conic", "color")}
    valid = np.asarray(ref.valid, np.float32)

    def weigh(p, lib):
        v = lib.asarray(valid) if lib is jnp else t(valid)
        tot = 0.0
        for f, w in wts.items():
            x = getattr(p, f)
            w = jnp.asarray(w) if lib is jnp else t(w)
            tot = tot + ((x * w).reshape(x.shape[0], -1).sum(-1) * v).sum()
        return tot + (p.opacity * v).sum()

    names = ("means", "scales", "quats", "opac", "shs", "tau")
    jargs = [jnp.asarray(sc[k]) for k in ("means3d", "scales", "quats", "opacities", "shs", "tau")]
    jg = jax.jit(jax.grad(lambda *a: weigh(_jax_prep(sc, tile, *a), jnp),
                          argnums=tuple(range(6))))(*jargs)
    targs = {k: t(n(a)).requires_grad_(True) for k, a in zip(names, jargs)}
    tg = torch.autograd.grad(weigh(_torch_prep(sc, tile, **targs), torch),
                             [targs[k] for k in names])
    for k, g, e in zip(names, tg, jg):
        assert_normalized(g, e, 1e-5, f"d_{k}")


BIN_SCENES = SCENES + [("huge_splats", None, None, None, 16, None)]


@pytest.mark.parametrize("name,n_g,width,height,tile,seed", BIN_SCENES)
def test_binning_exact(name, n_g, width, height, tile, seed):
    if name == "huge_splats":  # multi-tile splats next to sub-tile ones
        g = scenes.scene_huge_splats()
        sc = dict(means3d=g["means3d"], scales=g["scales"], quats=g["quats"],
                  opacities=g["opacities"], shs=g["shs"], view=g["viewmatrix"],
                  proj=g["projmatrix"], tanfovx=g["tanfovx"], tanfovy=g["tanfovy"],
                  width=g["width"], height=g["height"], sh_degree=0,
                  tau=np.zeros(6, np.float32))
    else:
        sc = _scene(n_g, width, height, seed)
    prep = jax.jit(lambda: _jax_prep(sc, tile))()
    tiles_x = (sc["width"] + tile - 1) // tile
    tiles_y = (sc["height"] + tile - 1) // tile
    ref = jax.jit(lambda p: jbinning.bin_gaussians_sorted(
        p, tiles_x=tiles_x, tiles_y=tiles_y, max_instances=1 << 14, chunk=128,
        tile_px=tile))(prep)
    got = binning.bin_gaussians_sorted(_prep_to_torch(prep), tiles_x=tiles_x,
                                       tiles_y=tiles_y, tile_px=tile)
    kept = got.s_gid.shape[0]
    assert kept > 0
    np.testing.assert_array_equal(n(got.s_gid), n(ref.s_gid)[:kept])
    np.testing.assert_array_equal(n(got.s_tile), n(ref.s_tile)[:kept])
    assert (n(ref.s_gid)[kept:] == -1).all()  # the JAX tail: culled + padding
    np.testing.assert_array_equal(n(got.starts), n(ref.starts))
    np.testing.assert_array_equal(n(got.tile_counts), n(ref.tile_counts))
    assert got.num_instances == int(ref.num_instances)


def _blend_loss(out, lib, h, w):
    wgt = (np.arange(h * w, dtype=np.float32).reshape(1, h, w) % 7 - 3.0) / 7.0
    wgt = jnp.asarray(wgt) if lib is jnp else t(wgt)
    return (lib.sum(out.color * wgt) + 0.5 * lib.sum(out.language * wgt)
            + 2.0 * lib.sum(out.depth * wgt) + lib.sum(out.opacity * wgt))


BG = np.asarray([0.15, 0.25, 0.35], np.float32)
DIFF = ("xy", "conic", "opacity", "color", "depth")


def _jax_blend(prep, lang, sc, tile, fn):
    def loss(xy, conic, op, color, depth, lang_):
        p = prep._replace(xy=xy, conic=conic, opacity=op, color=color, depth=depth)
        out = fn(p, lang_, jnp.asarray(BG), width=sc["width"], height=sc["height"], tile=tile)
        return _blend_loss(out, jnp, sc["height"], sc["width"]), out

    args = [getattr(prep, f) for f in DIFF] + [jnp.asarray(lang)]
    (_, out), grads = jax.jit(
        jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True))(*args)
    return out, grads


def _torch_blend(prep, lang, sc, tile, stats, oracle=False):
    leaves = {f: t(n(getattr(prep, f))).requires_grad_(True) for f in DIFF}
    lang_t = t(lang).requires_grad_(True)
    p = _prep_to_torch(prep)._replace(**leaves)
    kw = dict(width=sc["width"], height=sc["height"], tile=tile)
    out = (blend_oracle(p, lang_t, t(BG), **kw) if oracle
           else tiled.blend_tiled(p, lang_t, t(BG), stats=stats, **kw))
    grads = torch.autograd.grad(_blend_loss(out, torch, sc["height"], sc["width"]),
                                [leaves[f] for f in DIFF] + [lang_t], allow_unused=True)
    return out, grads


def _compare_blend(got, ref, gg, rg, ints=True, grads=True, what=""):
    for f in ("color", "language", "depth", "opacity", "final_t"):
        assert_normalized(getattr(got, f), getattr(ref, f), 1e-4, f"{what} {f}")
    if ints:
        for f in ("n_contrib", "n_touched"):
            np.testing.assert_array_equal(n(getattr(got, f)), n(getattr(ref, f)),
                                          err_msg=f"{what} {f}")
    if grads:
        for f, g, e in zip(DIFF + ("lang",), gg, rg):
            g = torch.zeros(e.shape) if g is None else g
            assert_normalized(g, e, 2e-3, f"{what} d_{f}")


@pytest.mark.parametrize("name,n_g,width,height,tile,seed", SCENES)
def test_blend_plain_vs_jax_tiled_and_oracle(name, n_g, width, height, tile, seed):
    """The plain blend (F_lang 15 and 0, stats on and off) against the JAX
    Pallas blend in interpret mode and the JAX oracle."""
    sc = _scene(n_g, width, height, seed, sh_degree=0)
    prep = jax.jit(lambda: _jax_prep(sc, tile))()
    lang = sc["lang"]
    ref_t, rg_t = _jax_blend(prep, lang, sc, tile, jblend_tiled)
    ref_o, rg_o = _jax_blend(prep, lang, sc, tile, jblend_oracle)
    got, gg = _torch_blend(prep, lang, sc, tile, stats=True)
    _compare_blend(got, ref_t, gg, rg_t, what="vs tiled")
    _compare_blend(got, ref_o, gg, rg_o, what="vs oracle")
    got_off, gg_off = _torch_blend(prep, lang, sc, tile, stats=False)
    _compare_blend(got_off, ref_t, gg_off, rg_t, ints=False, what="stats off")
    assert not n(got_off.n_touched).any() and not n(got_off.n_contrib).any()
    # F_lang 0: the tracking shape. Image outputs cannot see language.
    lang0 = lang[:, :0]
    ref0, rg0 = _jax_blend(prep, lang0, sc, tile, jblend_oracle)
    for stats in (True, False):
        got0, gg0 = _torch_blend(prep, lang0, sc, tile, stats=stats)
        _compare_blend(got0, ref0, gg0, rg0, ints=stats, what=f"F0 stats={stats}")
    # And the port's own oracle agrees with both.
    got_o, gg_o = _torch_blend(prep, lang, sc, tile, stats=True, oracle=True)
    _compare_blend(got_o, ref_o, gg_o, rg_o, what="port oracle")


GOLDEN_CASES = [(tile, name, backend) for tile in (16, 32) for name in sorted(scenes.SCENES)
                for backend in ("oracle", "cuda")]


@pytest.mark.parametrize("tile,name,backend", GOLDEN_CASES)
def test_goldens(tile, name, backend):
    golden = scenes.load_golden(REPO, name, tile)
    got = scenes.render_scene(scenes.SCENES[name](), backend, tile=tile)
    assert set(got) == set(golden)
    fwd_tol, grad_tol = (1e-5, 5e-5) if backend == "oracle" else (1e-4, 2e-3)
    for key, ref in golden.items():
        if key in scenes.INT_KEYS:
            np.testing.assert_array_equal(got[key], ref, err_msg=key)
        else:
            assert_normalized(got[key], ref, grad_tol if key in scenes.GRAD_KEYS else fwd_tol,
                              f"{name}/{key}")
    if backend == "cuda":
        # The tracking shape (F_lang 0, stats off) leaves images unchanged.
        got0 = scenes.render_scene(scenes.SCENES[name](), backend, tile=tile, lang=False,
                                   stats=False)
        for key in ("color", "depth", "opacity", "final_t"):
            assert_normalized(got0[key], golden[key], fwd_tol, f"F0 {name}/{key}")


@pytest.mark.parametrize("name", sorted(scenes.SCENES))
def test_numpy_scenes_match_fixtures(name):
    mine = scenes.SCENES[name]()
    ref = raster_fixtures.SCENES[name]()
    for key in ("means3d", "scales", "quats", "opacities", "shs", "language_features",
                "viewmatrix", "projmatrix"):
        a, b = mine[key], np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key
    s = ref["settings"]
    assert (mine["width"], mine["height"]) == (s.image_width, s.image_height)
    assert (mine["tanfovx"], mine["tanfovy"]) == (s.tanfovx, s.tanfovy)
    np.testing.assert_array_equal(scenes.BG, np.asarray(raster_fixtures.BG))


def test_blend_function_gradcheck_f64():
    """gradcheck (default tolerances, fast mode: random projections of the
    Jacobian instead of one backward per output pixel) of the autograd
    Function through its CPU path, on 8 Gaussians over 3x2 tiles."""
    sc = _scene(8, 24, 16, seed=5, sh_degree=0)
    sc["opacities"] = np.random.default_rng(5).uniform(0.3, 0.7, 8).astype(np.float32)
    sc["means3d"][:, 2] = np.linspace(2.5, 4.0, 8)
    tile = 8
    prep = _torch_prep(sc, tile)
    bins = binning.bin_gaussians_sorted(prep, tiles_x=3, tiles_y=2, tile_px=tile)
    assert bins.s_gid.shape[0] > 8  # several multi-tile instances
    lang = t(sc["lang"][:, :3]).double()
    depth = torch.where(prep.valid, prep.depth, torch.zeros_like(prep.depth))
    inputs = [x.detach().double().requires_grad_(True)
              for x in (prep.xy, prep.conic, prep.opacity, prep.color, lang, depth)]

    def fn(*xs):
        feat_img, final_t, _, _ = tiled._Blend.apply(
            *xs, bins.s_gid, bins.starts, bins.tile_counts, bins.emission, 24, 16, tile,
            True)
        return feat_img, final_t

    assert torch.autograd.gradcheck(fn, inputs, fast_mode=True)


def test_cpu_tensors_take_the_plain_path():
    tiled.FWD_STATS.reset()
    tiled.BWD_STATS.reset()
    got = scenes.render_scene(scenes.SCENES["alpha_clamp"](), "cuda", tile=16)
    assert np.isfinite(got["color"]).all()
    assert (tiled.FWD_STATS.plain_calls, tiled.BWD_STATS.plain_calls) == (1, 1)
    assert (tiled.FWD_STATS.launches, tiled.BWD_STATS.launches) == (0, 0)


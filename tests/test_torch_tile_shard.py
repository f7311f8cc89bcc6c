"""Port parity of the band-parallel render and tracking
(parallel/tile_shard.py) and of the forward blend's `py_limit`.

The scene is the JAX package's tests/test_tile_shard.py one (48x64, 160
Gaussians, 8 language channels, tile 16), made from a numpy seed. The JAX
functions run on the 8-device CPU mesh of tests/conftest.py with the Pallas
blend in interpret mode; the port's on a mesh of 8 CPU shards through the
blend kernels' plain versions. Each JAX function is traced once per module
(module-scoped fixtures).

Tolerances: band layout, crops, n_touched, radii and iteration counts
exact; images 1e-5 (depth 1e-4) absolute, as the JAX package holds its
banded render to its single-device one; gradients 2e-5 normalized against
the port's single-device path (the same plain arithmetic, summed per band)
and 1e-4 normalized against JAX (two implementations' float sums); tracked
poses 1e-5 against the port's single-device run and 1e-4 against JAX
(tests/test_torch_slam.py's tracking bound), losses 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import assert_normalized, n, t

from online_lang_splatting_tpu.ops import graphics as jgraphics
from online_lang_splatting_tpu.ops import lie as jlie
from online_lang_splatting_tpu.ops.raster import RasterSettings as JSettings
from online_lang_splatting_tpu.ops.raster import tiled as jtiled
from online_lang_splatting_tpu.ops.raster.preprocess import preprocess as jpreprocess
from online_lang_splatting_tpu.parallel import mesh as jmesh
from online_lang_splatting_tpu.parallel import tile_shard as jshard
from online_lang_splatting_tpu.slam.renderer import RenderInputs as JInputs
from online_lang_splatting_tpu.slam.renderer import render as jrender
from online_lang_splatting_tpu_torch.ops import lie
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings, tiled
from online_lang_splatting_tpu_torch.parallel import tile_shard as shard
from online_lang_splatting_tpu_torch.parallel.mesh import named_mesh
from online_lang_splatting_tpu_torch.slam.frontend import tracking_run
from online_lang_splatting_tpu_torch.slam.renderer import RenderInputs, render

H, W, F, P, TILE, N_SHARDS = 48, 64, 40.0, 160, 16, 8
TAU = np.array([0.01, -0.005, 0.008, 0.004, -0.003, 0.002], np.float32)
LRS = (np.float32(0.002), np.float32(0.002), np.float32(0.01))
ITERS = 12


def _numpy_scene(p=P, lang_dim=8, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(p, 4))
    return dict(
        xyz=np.stack([rng.uniform(-1.5, 1.5, p), rng.uniform(-1.0, 1.0, p),
                      rng.uniform(1.5, 6.0, p)], 1).astype(np.float32),
        opacity=rng.uniform(0.2, 0.95, p).astype(np.float32),
        scales=rng.uniform(0.02, 0.12, (p, 3)).astype(np.float32),
        quats=(q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32),
        shs=(rng.normal(size=(p, 1, 3)) * 0.3).astype(np.float32),
        language=(rng.normal(size=(p, lang_dim)) * 0.2).astype(np.float32))


@pytest.fixture(scope="module")
def scene():
    arrays = _numpy_scene()
    jset = JSettings(image_height=H, image_width=W, tanfovx=W / (2 * F),
                     tanfovy=H / (2 * F), sh_degree=0, backend="tpu",
                     max_instances=8192, tile=TILE)
    tset = RasterSettings(image_height=H, image_width=W, tanfovx=W / (2 * F),
                          tanfovy=H / (2 * F), sh_degree=0, tile=TILE)
    proj = np.asarray(jgraphics.projection_matrix(0.01, 100.0, W / 2, H / 2, F, F, W, H),
                      np.float32)
    jin = JInputs(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tin = RenderInputs(**{k: t(v) for k, v in arrays.items()})
    gt_view = np.asarray(jlie.se3_exp(jnp.asarray(TAU)), np.float32)
    gt = jrender(jin, jnp.asarray(gt_view), jnp.asarray(proj), jset)
    gt_frames = (n(gt.color), n(gt.depth), np.ones((1, H, W), np.float32))
    return dict(jin=jin, tin=tin, jset=jset, tset=tset, proj=proj, gt=gt_frames,
                jmesh=jmesh.make_mesh(N_SHARDS),
                mesh=named_mesh(["cpu"] * N_SHARDS))


def _jax_prep(jin, jset, proj):
    view = jnp.eye(4)
    campos = jnp.zeros(3)
    return jpreprocess(jin.xyz, jin.scales, jin.quats, jin.opacity, view,
                       jnp.asarray(proj) @ view, campos, shs=jin.shs, sh_degree=0,
                       width=W, height=H, tan_fovx=jset.tanfovx, tan_fovy=jset.tanfovy,
                       tile=TILE)


def test_band_layout_matches_jax():
    for h, tile, k in ((48, 16, 8), (680, 16, 4), (680, 16, 8), (680, 32, 4), (5, 16, 3)):
        assert shard.band_layout(h, tile, k) == jshard.band_layout(h, tile, k)
    # The replica-scale case: 43 tile rows padded to 44, bands of 176 rows;
    # the last band starts at row 528 and holds 152 image rows.
    assert shard.band_layout(680, 16, 4) == (11, 176, 704)


@pytest.mark.parametrize("y0", [0, 16, 32, 48])
def test_crop_band_matches_jax_exactly(scene, y0):
    jprep = _jax_prep(scene["jin"], scene["jset"], scene["proj"])
    tprep = tiled.Preprocessed(*(t(f) for f in jprep))
    ref = jshard.crop_band(jprep, y0, band_h=16, tile=TILE, tiles_x=W // TILE)
    got = shard.crop_band(tprep, y0, band_h=16, tile=TILE)
    for name, a, b in zip(ref._fields, got, ref):
        np.testing.assert_array_equal(n(a), n(b), err_msg=name)


@pytest.mark.parametrize("py_limit", [None, 40, 8, 0])
def test_plain_forward_py_limit_matches_jax(scene, py_limit):
    """A row limit that cuts a tile mid-way (40 = 2.5 tiles of 16, 8 = half
    the first): n_touched exact against JAX blend_tiled(py_limit=...); the
    images do not depend on the limit."""
    jprep = _jax_prep(scene["jin"], scene["jset"], scene["proj"])
    tprep = tiled.Preprocessed(*(t(f) for f in jprep))
    lang = scene["jin"].language
    ref = jtiled.blend_tiled(jprep, lang, jnp.zeros(3), width=W, height=H, tile=TILE,
                             max_instances=8192, py_limit=py_limit)
    got = tiled.blend_tiled(tprep, t(lang), torch.zeros(3), width=W, height=H,
                            tile=TILE, py_limit=py_limit)
    np.testing.assert_array_equal(n(got.n_touched), n(ref.n_touched))
    full = tiled.blend_tiled(tprep, t(lang), torch.zeros(3), width=W, height=H, tile=TILE)
    if py_limit is not None:
        assert int(got.n_touched.sum()) < int(full.n_touched.sum())
    for k in ("color", "language", "depth", "final_t", "n_contrib"):
        np.testing.assert_allclose(n(getattr(got, k)), n(getattr(ref, k)), atol=1e-5,
                                   err_msg=k)
        np.testing.assert_array_equal(n(getattr(got, k)), n(getattr(full, k)), err_msg=k)


def _loss(out):
    return out.color.sum() + out.language.sum() + 0.1 * out.depth.sum()


@pytest.fixture(scope="module")
def jax_banded(scene):
    """JAX banded render outputs and the gradients of `_loss` with respect
    to (xyz, opacity, language), from one trace."""
    banded = jshard.make_banded_render(scene["jmesh"], scene["jset"], 8)
    jin, proj = scene["jin"], jnp.asarray(scene["proj"])

    def loss(xyz, opacity, language):
        out = banded(jin._replace(xyz=xyz, opacity=opacity, language=language),
                     jnp.eye(4), proj)
        return _loss(out), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jin.xyz, jin.opacity, jin.language)
    return out, grads


def test_banded_render_matches_jax_and_single_device(scene, jax_banded):
    tin, proj = scene["tin"], t(scene["proj"])
    got = shard.make_banded_render(scene["mesh"], scene["tset"])(tin, torch.eye(4), proj)
    single = render(tin, torch.eye(4), proj, scene["tset"])
    ref, _ = jax_banded
    for k, tol in (("color", 1e-5), ("language", 1e-5), ("depth", 1e-4),
                   ("opacity", 1e-5), ("final_t", 1e-5)):
        np.testing.assert_allclose(n(getattr(got, k)), n(getattr(single, k)), atol=tol,
                                   err_msg=k)
        # JAX's final_t is the first band's alone (its `final_t[0, :h]`
        # reads shard 0's block); the port assembles the whole frame.
        want = n(getattr(ref, k))
        have = n(getattr(got, k))[:want.shape[0]] if k == "final_t" else n(getattr(got, k))
        np.testing.assert_allclose(have, want, atol=tol, err_msg=k)
    assert n(ref.final_t).shape == (shard.band_layout(H, TILE, N_SHARDS)[1], W)
    for k in ("n_touched", "radii"):
        np.testing.assert_array_equal(n(getattr(got, k)), n(getattr(ref, k)), err_msg=k)
        np.testing.assert_array_equal(n(getattr(got, k)), n(getattr(single, k)), err_msg=k)
    assert int(got.n_touched.sum()) > 0


def test_banded_render_gradients_match(scene, jax_banded):
    tin, proj = scene["tin"], t(scene["proj"])
    leaves = [tin.xyz.clone().requires_grad_(True), tin.opacity.clone().requires_grad_(True),
              tin.language.clone().requires_grad_(True)]

    def grads(fn):
        x = tin._replace(xyz=leaves[0], opacity=leaves[1], language=leaves[2])
        return torch.autograd.grad(_loss(fn(x)), leaves)

    banded = shard.make_banded_render(scene["mesh"], scene["tset"])
    got = grads(lambda x: banded(x, torch.eye(4), proj))
    single = grads(lambda x: render(x, torch.eye(4), proj, scene["tset"]))
    _, ref = jax_banded
    for name, g, s, r in zip(("xyz", "opacity", "language"), got, single, ref):
        assert_normalized(g, s, 2e-5, f"{name} vs single device")
        assert_normalized(g, r, 1e-4, f"{name} vs JAX")
        assert float(g.abs().max()) > 0


def _jax_track(scene, keep_best, plateau_rtol, lr_decay):
    run = jshard.make_banded_tracking_run(scene["jmesh"], scene["jset"], max_iters=ITERS,
                                          keep_best=keep_best)
    gi, gd, gm = (jnp.asarray(x) for x in scene["gt"])
    return run(scene["jin"], jnp.eye(4), jnp.asarray(scene["proj"]), gi, gd, gm,
               jnp.float32(0.0), jnp.float32(0.0), LRS, jnp.float32(plateau_rtol),
               jnp.float32(lr_decay))


@pytest.fixture(scope="module")
def jax_tracks(scene):
    """The JAX banded tracking run, plain, lr-decay on plateau (one trace)
    and keep-best."""
    return {"plain": _jax_track(scene, False, 0.0, 1.0),
            "lr_decay": _jax_track(scene, False, 0.01, 0.5),
            "keep_best": _jax_track(scene, True, 0.0, 1.0)}


@pytest.mark.parametrize("case, keep_best, plateau_rtol, lr_decay", [
    ("plain", False, 0.0, 1.0), ("lr_decay", False, 0.01, 0.5),
    ("keep_best", True, 0.0, 1.0)])
def test_banded_tracking_run_matches_jax_and_single_device(
        scene, jax_tracks, case, keep_best, plateau_rtol, lr_decay):
    tin, proj = scene["tin"], t(scene["proj"])
    gi, gd, gm = (t(x) for x in scene["gt"])
    run = shard.make_banded_tracking_run(scene["mesh"], scene["tset"], max_iters=ITERS,
                                         keep_best=keep_best)
    got = run(tin, torch.eye(4), proj, gi, gd, gm, 0.0, 0.0, LRS, plateau_rtol, lr_decay)
    single = tracking_run(tin, torch.eye(4), proj, gi, gd, gm, 0.0, 0.0, LRS, plateau_rtol,
                          lr_decay, settings=scene["tset"], max_iters=ITERS,
                          keep_best=keep_best)
    ref = jax_tracks[case]
    # (view, ea, eb, n_iters, loss, median depth, visibility)
    assert got[3] == single[3] == int(ref[3])
    for other, tol in ((single, 1e-5), (ref, 1e-4)):
        np.testing.assert_allclose(n(got[0]), n(other[0]), atol=tol)
        np.testing.assert_allclose([float(got[1]), float(got[2])],
                                   [float(other[1]), float(other[2])], atol=tol)
        np.testing.assert_allclose(float(got[4]), float(other[4]), rtol=1e-5)
        np.testing.assert_allclose(float(got[5]), float(other[5]), rtol=1e-5)
        np.testing.assert_array_equal(n(got[6]), n(other[6]))
    assert np.abs(n(got[0]) - np.eye(4)).max() > 1e-3  # the pose moved
    gt_view = n(lie.se3_exp(t(TAU)))
    assert np.abs(n(got[0]) - gt_view)[:3, 3].max() < np.abs(gt_view[:3, 3]).max()


def test_banded_render_gradients_sum_in_band_order(scene):
    """Every replicated input's gradient (each RenderInputs field, the
    background and both pose deltas) is the left fold of the bands' own
    gradients in band order, bit for bit: a fixed order, as JAX's psum.
    The loss weighs every output pixel by a seeded value, so the bands'
    terms differ and their float sum depends on the order."""
    tin, proj, s = scene["tin"], t(scene["proj"]), scene["tset"]
    rng = np.random.default_rng(5)
    base = dict(tin._asdict(), bg=t(rng.uniform(size=3).astype(np.float32)),
                cam_trans_delta=torch.zeros(3), cam_rot_delta=torch.zeros(3))
    _, band_h, padded_h = shard.band_layout(H, TILE, N_SHARDS)
    weights = {k: t(rng.normal(size=shape).astype(np.float32)) for k, shape in (
        ("color", (3, padded_h, W)), ("language", (tin.language.shape[1], padded_h, W)),
        ("depth", (1, padded_h, W)), ("opacity", (1, padded_h, W)),
        ("final_t", (padded_h, W)))}

    def leaves():
        return {k: v.clone().requires_grad_(True) for k, v in base.items()}

    def weighted(out, y0, rows):
        return sum((getattr(out, k)[..., :rows, :] * w[..., y0:y0 + rows, :]).sum()
                   for k, w in weights.items())

    def split(x):
        fields = {k: x[k] for k in RenderInputs._fields}
        return RenderInputs(**fields), {k: x[k] for k in x if k not in fields}

    x = leaves()
    inputs, extra = split(x)
    got = torch.autograd.grad(
        weighted(shard.banded_render(scene["mesh"], inputs, torch.eye(4), proj, s, **extra),
                 0, H), list(x.values()))
    want = [None] * len(base)
    for k in range(N_SHARDS):
        rows = min(max(H - k * band_h, 0), band_h)
        xk = leaves()
        inputs_k, extra_k = split(xk)
        out, _ = shard._band_blend(inputs_k, torch.eye(4), proj, s, k, band_h=band_h,
                                   **extra_k)
        gk = torch.autograd.grad(weighted(out, k * band_h, rows), list(xk.values()),
                                 allow_unused=True)
        want = [a if b is None else b if a is None else a + b for a, b in zip(want, gk)]
    for name, g, w in zip(base, got, want):
        assert float(w.abs().max()) > 0, name
        assert torch.equal(g, w), f"{name}: {int((g != w).sum())} of {g.numel()} differ"

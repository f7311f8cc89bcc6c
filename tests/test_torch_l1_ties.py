"""The L1 gradient at a zero residual: the port's `ops.losses.abs_` against
`jax.grad(jnp.abs)`, and one mapping step's language-feature gradient under
zero language supervision (features and supervision both exactly zero),
the port against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import assert_normalized, jax_params_aux, map_from_frame, n, t

from online_lang_splatting_tpu.ops import losses as jlosses
from online_lang_splatting_tpu.ops.raster import RasterSettings as JSettings
from online_lang_splatting_tpu.slam import backend as jbackend
from online_lang_splatting_tpu.slam import losses as jslam_losses
from online_lang_splatting_tpu_torch.convert import gaussians_from_numpy
from online_lang_splatting_tpu_torch.ops import losses
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings
from online_lang_splatting_tpu_torch.slam import backend, datasets
from online_lang_splatting_tpu_torch.slam import losses as slam_losses
from online_lang_splatting_tpu_torch.slam.config import load_config

SMOKE = "configs/synthetic/smoke.yaml"


@pytest.mark.parametrize("x", [0.0, -0.0, 1.5, -2.0])
def test_abs_gradient_matches_jax(x):
    xt = torch.tensor(x, requires_grad=True)
    losses.abs_(xt).backward()
    assert float(xt.grad) == float(jax.grad(jnp.abs)(jnp.float32(x)))
    assert float(losses.abs_(torch.tensor(x))) == abs(x)


def test_l1_losses_match_jax_at_ties():
    """Residuals with exact zeros: the value and gradient of the L1 terms
    equal the JAX package's (the isotropic loss at an isotropic Gaussian,
    the mapping loss where render and frame agree)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 8)).astype(np.float32)
    y = x.copy()
    y[:, :4] += rng.normal(size=(3, 4, 8)).astype(np.float32)
    xt = t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(losses.l1_loss(xt, t(y)), [xt])
    ref = jax.grad(jlosses.l1_loss)(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(n(g), n(ref))

    scaling = np.log(np.full((6, 3), 0.05, np.float32))
    scaling[3:] += rng.normal(size=(3, 3)).astype(np.float32) * 0.1
    active = np.array([True] * 5 + [False])
    st = t(scaling).requires_grad_(True)
    (g,) = torch.autograd.grad(slam_losses.isotropic_loss(torch.exp(st), t(active)), [st])
    ref = jax.grad(lambda s: jslam_losses.isotropic_loss(jnp.exp(s), jnp.asarray(active)))(
        jnp.asarray(scaling))
    np.testing.assert_allclose(n(g), n(ref), rtol=1e-6, atol=1e-7)

    image = rng.uniform(size=(3, 8, 8)).astype(np.float32)
    depth = rng.uniform(1, 2, size=(1, 8, 8)).astype(np.float32)
    args = (image, depth, image.copy(), depth.copy())
    ti = [t(a).requires_grad_(True) for a in args[:2]]
    g = torch.autograd.grad(slam_losses.loss_mapping_rgbd(
        *ti, *map(t, args[2:]), torch.tensor(0.0), torch.tensor(0.0)), ti)
    ref = jax.grad(lambda a, b: jslam_losses.loss_mapping_rgbd(
        a, b, *map(jnp.asarray, args[2:]), jnp.float32(0.0), jnp.float32(0.0)),
        argnums=(0, 1))(*map(jnp.asarray, args[:2]))
    for a, b in zip(g, ref):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6)
    assert float(np.abs(n(g[0])).max()) > 0


def test_zero_language_supervision_gradient_matches_jax():
    """One mapping step's slot gradients on smoke.yaml with language on,
    the map's language features zero and the supervision zero: the
    rendered residual is exactly zero everywhere, and the language
    gradient is JAX's (nonzero: d|r|/dr = 1 at r = 0)."""
    cfg = load_config(SMOKE)
    ds = datasets.SyntheticDataset(cfg)
    from online_lang_splatting_tpu_torch.ops import graphics

    proj = n(graphics.projection_matrix(0.01, 100.0, ds.cx, ds.cy, ds.fx, ds.fy,
                                        ds.width, ds.height))
    tree = map_from_frame(ds, seed=2)
    tree["language"][:] = 0.0
    jp, ja = jax_params_aux(tree)
    tp, ta, _ = gaussians_from_numpy(tree)
    frames = [ds[i] for i in (0, 2)]
    s = len(frames)
    slot_r = np.stack([f[2][:3, :3] for f in frames]).astype(np.float32)
    slot_t = np.stack([f[2][:3, 3] for f in frames]).astype(np.float32)
    slot_e = np.zeros(s, np.float32)
    images = np.stack([f[0] for f in frames])
    depths = np.stack([f[1][None] for f in frames])
    langs = np.zeros((s, 15, 24, 24), np.float32)
    on = np.array([True, True])
    kw = dict(image_height=ds.height, image_width=ds.width, tanfovx=np.tan(ds.fovx / 2),
              tanfovy=np.tan(ds.fovy / 2), sh_degree=0, tile=32)
    ref = jbackend.scan_slot_grads(
        jp, ja.active, jnp.asarray(proj), *map(jnp.asarray, (slot_r, slot_t, slot_e, slot_e)),
        *map(jnp.asarray, (images, depths, langs, on)), jnp.asarray(on, jnp.float32),
        jnp.float32(1.0), settings=JSettings(backend="oracle", **kw), init_mode=False)
    got = backend.scan_slot_grads(
        tp, ta.active, t(proj), *map(t, (slot_r, slot_t, slot_e, slot_e)), list(t(images)),
        list(t(depths)), list(t(langs)), list(on), list(on), 1.0,
        settings=RasterSettings(backend="cuda", **kw), init_mode=False)
    g_lang, r_lang = n(got[0].language), n(ref[0].language)
    assert float(np.abs(r_lang).max()) > 0
    assert_normalized(g_lang, r_lang, 2e-3, "language gradient")
    assert float(np.abs(g_lang).max()) > 0.5 * float(np.abs(r_lang).max())
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5)

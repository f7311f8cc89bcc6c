"""Port parity of the disentangle-optim rasterization
(ops/raster/disentangled.py): the JAX package's three cases
(tests/test_raster_disentangled.py) on the port, then its outputs and
gradients against JAX `rasterize_disentangled` on the same scene (48x32, 48
Gaussians, 3 language channels: the blend at C = 4 and C = 7), the JAX side
through the Pallas blend in interpret mode.

Tolerances: as the JAX cases (1e-6 absolute within the port, integers
exact); against JAX, images 1e-5 absolute, n_touched and radii exact,
gradients 1e-4 normalized (two implementations' float sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_scene
from torch_helpers import assert_normalized, n, t

from online_lang_splatting_tpu.ops.raster.disentangled import (
    rasterize_disentangled as jrasterize_disentangled)
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings, rasterize
from online_lang_splatting_tpu_torch.ops.raster.disentangled import rasterize_disentangled

GEOMETRY = ("means3d", "opacities", "scales", "quats", "opacities_lang", "scales_lang",
            "quats_lang")


def _numpy_scene(seed=0):
    scene = random_scene(n=48, width=48, height=32, seed=seed, lang_dim=3,
                         backend="tpu", tile=16)
    rng = np.random.default_rng(seed + 100)
    scene["opacities_lang"] = jnp.asarray(rng.uniform(0.3, 0.9, 48), dtype=jnp.float32)
    scene["scales_lang"] = scene["scales"] * 1.5
    q = rng.normal(size=(48, 4)).astype(np.float32)
    scene["quats_lang"] = jnp.asarray(q / np.linalg.norm(q, axis=1, keepdims=True))
    return scene


@pytest.fixture(scope="module")
def scenes():
    jscene = _numpy_scene()
    s = jscene["settings"]
    tscene = {k: t(v) for k, v in jscene.items() if k != "settings"}
    tscene["settings"] = RasterSettings(
        image_height=s.image_height, image_width=s.image_width, tanfovx=s.tanfovx,
        tanfovy=s.tanfovy, sh_degree=s.sh_degree, tile=s.tile)
    return jscene, tscene


def _run(scene, **kw):
    return rasterize_disentangled(
        *(scene[k] for k in GEOMETRY), viewmatrix=scene["viewmatrix"],
        projmatrix=scene["projmatrix"], settings=scene["settings"], shs=scene["shs"],
        language_features=scene["language_features"], **kw)


def test_color_matches_entangled_color_pass(scenes):
    _, scene = scenes
    out = _run(scene)
    ref = rasterize(scene["means3d"], scene["opacities"], scene["scales"], scene["quats"],
                    shs=scene["shs"], viewmatrix=scene["viewmatrix"],
                    projmatrix=scene["projmatrix"], settings=scene["settings"])
    np.testing.assert_allclose(n(out.color), n(ref.color), atol=1e-6)
    np.testing.assert_allclose(n(out.depth), n(ref.depth), atol=1e-6)
    np.testing.assert_array_equal(n(out.radii), n(ref.radii))


def test_language_uses_own_geometry(scenes):
    _, scene = scenes
    out = _run(scene)
    ref = rasterize(scene["means3d"], scene["opacities_lang"], scene["scales_lang"],
                    scene["quats_lang"], colors_precomp=torch.zeros((48, 3)),
                    language_features=scene["language_features"],
                    viewmatrix=scene["viewmatrix"], projmatrix=scene["projmatrix"],
                    settings=scene["settings"])
    np.testing.assert_allclose(n(out.language), n(ref.language), atol=1e-6)
    np.testing.assert_allclose(n(out.opacity_lang), n(ref.opacity), atol=1e-6)
    np.testing.assert_array_equal(n(out.n_touched_lang), n(ref.n_touched))
    assert float((out.final_t - out.final_t_lang).abs().max()) > 1e-3


def _loss(out):
    return out.color.sum() + out.language.sum()


def test_gradients_flow_to_both_geometries(scenes):
    _, scene = scenes
    op = scene["opacities"].clone().requires_grad_(True)
    op_l = scene["opacities_lang"].clone().requires_grad_(True)
    rho = torch.zeros(3, requires_grad=True)
    out = _run(dict(scene, opacities=op, opacities_lang=op_l), cam_trans_delta=rho)
    g_op, g_opl, g_rho = torch.autograd.grad(_loss(out), [op, op_l, rho])
    assert float(g_op.abs().max()) > 0
    assert float(g_opl.abs().max()) > 0
    assert bool(torch.isfinite(g_rho).all()) and float(g_rho.abs().max()) > 0


DIFF = ("opacities", "scales", "opacities_lang", "scales_lang", "quats_lang",
        "language_features")


def test_outputs_and_gradients_match_jax(scenes):
    """Both passes and the summed pose gradient of one perturbation."""
    jscene, scene = scenes
    rho0 = np.array([0.02, -0.01, 0.03], np.float32)
    theta0 = np.array([0.01, 0.02, -0.01], np.float32)

    def jloss(rho, theta, *vals):
        out = jrasterize_disentangled(
            *(dict(jscene, **dict(zip(DIFF, vals)))[k] for k in GEOMETRY),
            viewmatrix=jscene["viewmatrix"], projmatrix=jscene["projmatrix"],
            settings=jscene["settings"], shs=jscene["shs"],
            language_features=vals[-1], cam_trans_delta=rho, cam_rot_delta=theta)
        return _loss(out), out

    (_, ref), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(2 + len(DIFF))),
                                          has_aux=True)(
        jnp.asarray(rho0), jnp.asarray(theta0), *(jscene[k] for k in DIFF))

    leaves = [t(rho0).requires_grad_(True), t(theta0).requires_grad_(True)] + [
        scene[k].clone().requires_grad_(True) for k in DIFF]
    out = _run(dict(scene, **dict(zip(DIFF, leaves[2:]))), cam_trans_delta=leaves[0],
               cam_rot_delta=leaves[1])
    grads = torch.autograd.grad(_loss(out), leaves)

    for k in ("color", "language", "depth", "opacity", "opacity_lang", "final_t",
              "final_t_lang"):
        np.testing.assert_allclose(n(getattr(out, k)), n(getattr(ref, k)), atol=1e-5,
                                   err_msg=k)
    for k in ("radii", "radii_lang", "n_touched", "n_touched_lang"):
        np.testing.assert_array_equal(n(getattr(out, k)), n(getattr(ref, k)), err_msg=k)
    assert float((out.final_t - out.final_t_lang).abs().max()) > 1e-3
    for name, g, r in zip(("rho", "theta") + DIFF, grads, jgrads):
        assert_normalized(g, r, 1e-4, name)
        assert float(g.abs().max()) > 0, name

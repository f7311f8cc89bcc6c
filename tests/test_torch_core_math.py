"""Port parity: lie / graphics / sh / losses / SLAM losses against the JAX
package on numpy-seeded inputs. Values atol 1e-6, gradients atol 1e-5
(float32 arithmetic in two frameworks' operation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, t

from online_lang_splatting_tpu.ops import graphics as jgraphics
from online_lang_splatting_tpu.ops import lie as jlie
from online_lang_splatting_tpu.ops import losses as jlosses
from online_lang_splatting_tpu.ops import sh as jsh
from online_lang_splatting_tpu.slam import losses as jslosses
from online_lang_splatting_tpu_torch.ops import graphics, lie, losses, sh
from online_lang_splatting_tpu_torch.slam import losses as slosses

VAL, GRAD = 1e-6, 1e-5


def _tau(scale, seed):
    rng = np.random.default_rng(seed)
    tau = rng.normal(size=6).astype(np.float32)
    tau[3:] *= scale
    return tau


@pytest.mark.parametrize("rot_scale", [0.0, 1e-6, 1e-4, 9e-4, 1.1e-3, 0.3, 2.0])
def test_se3_exp_values_and_grads(rot_scale):
    tau = _tau(rot_scale, seed=int(rot_scale * 1e6) % 97)
    w = np.random.default_rng(1).normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_allclose(n(lie.se3_exp(t(tau))), n(jlie.se3_exp(jnp.asarray(tau))),
                               atol=VAL)
    jg = jax.grad(lambda x: jnp.sum(jlie.se3_exp(x) * w))(jnp.asarray(tau))
    x = t(tau).requires_grad_(True)
    (tg,) = torch.autograd.grad((lie.se3_exp(x) * t(w)).sum(), x)
    assert np.isfinite(n(tg)).all()
    np.testing.assert_allclose(n(tg), n(jg), atol=GRAD)


def test_so3_exp_update_pose_rt_to_mat4():
    rng = np.random.default_rng(2)
    theta = rng.normal(size=3).astype(np.float32) * 0.4
    np.testing.assert_allclose(n(lie.so3_exp(t(theta))), n(jlie.so3_exp(jnp.asarray(theta))),
                               atol=VAL)
    r = n(jlie.so3_exp(jnp.asarray(theta)))
    tr = rng.normal(size=3).astype(np.float32)
    dt, dr = rng.normal(size=3).astype(np.float32) * 1e-2, rng.normal(size=3).astype(np.float32) * 1e-2
    got = lie.update_pose(t(r), t(tr), t(dt), t(dr))
    ref = jlie.update_pose(jnp.asarray(r), jnp.asarray(tr), jnp.asarray(dt), jnp.asarray(dr))
    for g, e in zip(got, ref):
        np.testing.assert_allclose(n(g), n(e), atol=VAL)
    np.testing.assert_allclose(n(lie.rt_to_mat4(t(r), t(tr))),
                               n(jlie.rt_to_mat4(jnp.asarray(r), jnp.asarray(tr))), atol=0)


def test_projection_matrix_and_fov():
    args = (0.01, 100.0, 47.5, 31.5, 80.0, 80.0, 96, 64)
    np.testing.assert_array_equal(n(graphics.projection_matrix(*args)),
                                  n(jgraphics.projection_matrix(*args)))
    assert graphics.focal_to_fov(600.0, 1200) == jgraphics.focal_to_fov(600.0, 1200)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_to_color_values_and_grads(deg):
    rng = np.random.default_rng(deg)
    p = 64
    shs = rng.normal(size=(p, (deg + 1) ** 2, 3)).astype(np.float32) * 0.4
    means = rng.normal(size=(p, 3)).astype(np.float32)
    campos = rng.normal(size=3).astype(np.float32)
    w = rng.normal(size=(p, 3)).astype(np.float32)
    ref = jsh.sh_to_color(deg, jnp.asarray(shs), jnp.asarray(means), jnp.asarray(campos))
    got = sh.sh_to_color(deg, t(shs), t(means), t(campos))
    np.testing.assert_allclose(n(got), n(ref), atol=VAL)
    jg = jax.grad(lambda s, m: jnp.sum(jsh.sh_to_color(deg, s, m, jnp.asarray(campos)) * w),
                  argnums=(0, 1))(jnp.asarray(shs), jnp.asarray(means))
    ts, tm = t(shs).requires_grad_(True), t(means).requires_grad_(True)
    tg = torch.autograd.grad((sh.sh_to_color(deg, ts, tm, t(campos)) * t(w)).sum(), [ts, tm],
                             allow_unused=True)  # degree 0 ignores the means
    for g, e in zip(tg, jg):
        g = torch.zeros(e.shape) if g is None else g
        np.testing.assert_allclose(n(g), n(e), atol=GRAD)
    np.testing.assert_allclose(n(sh.rgb_to_sh(t(w))), n(jsh.rgb_to_sh(jnp.asarray(w))), atol=VAL)


def test_image_gradient_and_mask():
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(1, 20, 28)).astype(np.float32)
    img[0, :3] = 0.0  # flat, dark rows exercise the |value| > eps mask
    for got, ref in zip(losses.image_gradient(t(img)), jlosses.image_gradient(jnp.asarray(img))):
        np.testing.assert_allclose(n(got), n(ref), atol=VAL)
    for got, ref in zip(losses.image_gradient_mask(t(img)),
                        jlosses.image_gradient_mask(jnp.asarray(img))):
        np.testing.assert_array_equal(n(got), n(ref))


def test_psnr():
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(size=(3, 12, 16)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(n(losses.psnr(t(a), t(b))),
                               n(jlosses.psnr(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)


def _slam_images(seed=6, h=16, w=20):
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(3, h, w)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (1, h, w)).astype(np.float32)
    opacity = rng.uniform(0.8, 1.0, (1, h, w)).astype(np.float32)
    gt_image = rng.uniform(size=(3, h, w)).astype(np.float32)
    gt_image[:, :2] = 0.0  # below the RGB boundary threshold
    gt_depth = rng.uniform(0.0, 3.0, (1, h, w)).astype(np.float32)
    grad_mask = (rng.uniform(size=(1, h, w)) > 0.5).astype(np.float32)
    return image, depth, opacity, gt_image, gt_depth, grad_mask


def test_tracking_loss_values_and_grads():
    image, depth, opacity, gt_image, gt_depth, grad_mask = _slam_images()
    ea, eb = np.float32(0.03), np.float32(-0.02)

    def jl(img, dep, op, a, b):
        return jslosses.loss_tracking_rgbd(img, dep, op, jnp.asarray(gt_image),
                                           jnp.asarray(gt_depth), jnp.asarray(grad_mask), a, b)

    args = [jnp.asarray(x) for x in (image, depth, opacity, ea, eb)]
    ref = jl(*args)
    jg = jax.grad(jl, argnums=(0, 1, 2, 3, 4))(*args)
    targs = [t(x).requires_grad_(True) for x in (image, depth, opacity, ea, eb)]
    got = slosses.loss_tracking_rgbd(*targs[:3], t(gt_image), t(gt_depth), t(grad_mask),
                                     targs[3], targs[4])
    np.testing.assert_allclose(n(got), n(ref), atol=VAL)
    for g, e in zip(torch.autograd.grad(got, targs), jg):
        np.testing.assert_allclose(n(g), n(e), atol=GRAD)


@pytest.mark.parametrize("init", [False, True])
def test_mapping_loss_values_and_grads(init):
    image, depth, _, gt_image, gt_depth, _ = _slam_images(seed=7)
    ea, eb = np.float32(-0.05), np.float32(0.01)

    def jl(img, dep):
        return jslosses.loss_mapping_rgbd(img, dep, jnp.asarray(gt_image), jnp.asarray(gt_depth),
                                          jnp.float32(ea), jnp.float32(eb), initialization=init)

    ref = jl(jnp.asarray(image), jnp.asarray(depth))
    jg = jax.grad(jl, argnums=(0, 1))(jnp.asarray(image), jnp.asarray(depth))
    ti, td = t(image).requires_grad_(True), t(depth).requires_grad_(True)
    got = slosses.loss_mapping_rgbd(ti, td, t(gt_image), t(gt_depth), t(ea), t(eb),
                                    initialization=init)
    np.testing.assert_allclose(n(got), n(ref), atol=VAL)
    for g, e in zip(torch.autograd.grad(got, [ti, td]), jg):
        np.testing.assert_allclose(n(g), n(e), atol=GRAD)


def test_isotropic_loss_and_median_depth():
    rng = np.random.default_rng(8)
    scaling = rng.uniform(0.01, 0.2, (50, 3)).astype(np.float32)
    active = rng.uniform(size=50) > 0.3
    ref = jslosses.isotropic_loss(jnp.asarray(scaling), jnp.asarray(active))
    jg = jax.grad(lambda s: jslosses.isotropic_loss(s, jnp.asarray(active)))(jnp.asarray(scaling))
    ts = t(scaling).requires_grad_(True)
    got = slosses.isotropic_loss(ts, t(active))
    np.testing.assert_allclose(n(got), n(ref), atol=VAL)
    np.testing.assert_allclose(n(torch.autograd.grad(got, ts)[0]), n(jg), atol=GRAD)

    depth = rng.uniform(0.0, 4.0, (1, 9, 10)).astype(np.float32)
    opacity = rng.uniform(0.9, 1.0, (1, 9, 10)).astype(np.float32)
    for d in (depth, depth[:, :, :9]):  # odd and even valid counts
        o = opacity[:, :, : d.shape[2]]
        np.testing.assert_allclose(
            n(slosses.median_depth(t(d), t(o))),
            n(jslosses.median_depth(jnp.asarray(d), jnp.asarray(o))), atol=VAL)

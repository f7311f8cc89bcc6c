"""Port parity of the Gaussian map (models/gaussians.py, ops/knn.py):
masked Adam, the exponential LR, kNN scale init, keyframe extension,
densify-and-prune with the JAX split noise injected, opacity resets and
compaction. Slot-by-slot comparison at rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import jax_params_aux, n, numpy_map, t

from online_lang_splatting_tpu.models import gaussians as JG
from online_lang_splatting_tpu.ops.knn import knn_mean_sq_dist as jknn
from online_lang_splatting_tpu_torch.convert import gaussians_from_numpy
from online_lang_splatting_tpu_torch.models import gaussians as G
from online_lang_splatting_tpu_torch.ops.knn import knn_mean_sq_dist

RTOL, ATOL = 1e-5, 1e-7


def _close(got_tree, ref_tree, what):
    for f, g, e in zip(ref_tree._fields, got_tree, ref_tree):
        g, e = n(g), n(e)
        if e.dtype == bool or np.issubdtype(e.dtype, np.integer):
            np.testing.assert_array_equal(g, e, err_msg=f"{what}.{f}")
        else:
            np.testing.assert_allclose(g, e, rtol=RTOL, atol=ATOL, err_msg=f"{what}.{f}")


def _both(tree):
    jp, ja = jax_params_aux(tree)
    tp, ta, topt = gaussians_from_numpy(tree)
    return (jp, ja, JG.init_adam(jp)), (tp, ta, topt)


def test_adam_step_and_expon_lr():
    rng = np.random.default_rng(0)
    tree = numpy_map(seed=0, n_pts=40, cap=64)
    (jp, ja, jo), (tp, ta, to) = _both(tree)
    lrs = [np.float32(x) for x in (1.6e-4, 2.5e-3, 1.25e-4, 1e-3, 1e-3, 5e-2, 2.5e-3)]
    for step in range(3):
        grads = [rng.normal(size=np.shape(p)).astype(np.float32) for p in tree_params(tree)]
        jp, jo = JG.adam_step(jp, JG.GaussianParams(*map(jnp.asarray, grads)), jo,
                              JG.LearningRates(*map(jnp.asarray, lrs)), ja.active)
        tp, to = G.adam_step(tp, G.GaussianParams(*map(t, grads)), to,
                             G.LearningRates(*map(t, lrs)), ta.active)
    _close(tp, jp, "params")
    _close(to.mu, jo.mu, "mu")
    _close(to.nu, jo.nu, "nu")
    assert int(to.count) == int(jo.count) == 3
    for step in (0.0, 1.0, 1234.0, 30000.0, 50000.0):
        args = (1.6e-4, 1.6e-6)
        kw = dict(lr_delay_mult=0.01, max_steps=30000)
        np.testing.assert_allclose(n(G.expon_lr(step, *args, **kw)),
                                   n(JG.expon_lr(jnp.float32(step), *args, **kw)), rtol=RTOL)
        kw["lr_delay_steps"] = 500
        np.testing.assert_allclose(n(G.expon_lr(step, *args, **kw)),
                                   n(JG.expon_lr(jnp.float32(step), *args, **kw)), rtol=RTOL)


def tree_params(tree):
    return [tree[f] for f in JG.GaussianParams._fields]


@pytest.mark.parametrize("n_pts,block", [(300, 1024), (300, 128)])
def test_knn_mean_sq_dist(n_pts, block):
    rng = np.random.default_rng(n_pts + block)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32)
    pts[10:20] = pts[0]  # exact ties
    valid = rng.uniform(size=n_pts) > 0.2
    ref = jknn(jnp.asarray(pts), jnp.asarray(valid), block=block)
    got = knn_mean_sq_dist(t(pts), t(valid), block=block)
    np.testing.assert_allclose(n(got), n(ref), rtol=RTOL, atol=1e-7)


def test_extend_points_slot_by_slot():
    rng = np.random.default_rng(1)
    tree = numpy_map(seed=1, n_pts=30, cap=128)
    tree["active"][5:9] = False  # holes are refilled first
    (jp, ja, jo), (tp, ta, to) = _both(tree)
    m = 70
    xyz = (rng.normal(size=(m, 3)) + [0, 0, 3]).astype(np.float32)
    rgb = rng.uniform(size=(m, 3)).astype(np.float32)
    valid = rng.uniform(size=m) > 0.25
    ref = JG.extend_points(jp, ja, jo, xyz=jnp.asarray(xyz), rgb=jnp.asarray(rgb),
                           valid=jnp.asarray(valid), kf_id=7, point_size=0.05)
    got = G.extend_points(tp, ta, to, xyz=t(xyz), rgb=t(rgb), valid=t(valid), kf_id=7,
                          point_size=0.05)
    _close(got[0], ref[0], "params")
    _close(got[1], ref[1], "aux")
    _close(got[2].mu, ref[2].mu, "mu")
    assert bool(got[3]) == bool(ref[3])


def test_densify_and_prune_with_injected_noise():
    rng = np.random.default_rng(2)
    cap = 256
    tree = numpy_map(seed=2, n_pts=120, cap=cap)
    tree["scaling"][:60] = np.log(rng.uniform(0.001, 0.004, (60, 3)))  # clone-size
    tree["xyz_grad_accum"] = rng.uniform(0.0, 0.01, cap).astype(np.float32)
    tree["denom"] = rng.integers(0, 5, cap).astype(np.float32)
    tree["max_radii2d"] = rng.uniform(0.0, 30.0, cap).astype(np.float32)
    tree["kf_id"] = rng.integers(0, 4, cap).astype(np.int32)
    tree["n_obs"] = rng.integers(0, 9, cap).astype(np.int32)
    jp, _ = jax_params_aux(tree)
    ja = JG.GaussianAux(*(jnp.asarray(tree[f]) for f in JG.GaussianAux._fields))
    jo = JG.init_adam(jp)
    jo = jo._replace(mu=jax.tree.map(lambda x: x + 0.1, jo.mu))
    tp, ta, _ = gaussians_from_numpy(tree)
    to = G.AdamState(mu=G.GaussianParams(*(t(n(x)) for x in jo.mu)),
                     nu=G.GaussianParams(*(t(n(x)) for x in jo.nu)), count=t(np.int32(0)))
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    noise = tuple(t(n(jax.random.normal(k, (cap, 3)))) for k in (k1, k2))
    kw = dict(max_grad=0.002, min_opacity=0.3, extent=1.0, max_screen_size=20,
              percent_dense=0.01)
    ref = JG.densify_and_prune(jp, ja, jo, key, **kw)
    got = G.densify_and_prune(tp, ta, to, noise, **kw)
    assert int(n(ref[1].active).sum()) != int(tree["active"].sum())  # edits happened
    _close(got[0], ref[0], "params")
    _close(got[1], ref[1], "aux")
    _close(got[2].mu, ref[2].mu, "mu")
    _close(got[2].nu, ref[2].nu, "nu")
    assert bool(got[3]) == bool(ref[3])


def test_opacity_resets_prune_and_compact():
    rng = np.random.default_rng(4)
    tree = numpy_map(seed=4, n_pts=50, cap=96)
    (jp, ja, jo), (tp, ta, to) = _both(tree)
    visible = rng.uniform(size=96) > 0.5
    _close(G.reset_opacity_nonvisible(tp, to, t(visible))[0],
           JG.reset_opacity_nonvisible(jp, jo, jnp.asarray(visible))[0], "nonvisible")
    _close(G.reset_opacity(tp, to)[0], JG.reset_opacity(jp, jo)[0], "reset")
    mask = rng.uniform(size=96) > 0.7
    _close(G.prune_only(tp, ta, t(mask)), JG.prune_only(jp, ja, jnp.asarray(mask)), "prune")
    ref = JG.compact(jp, ja, jo, 64)
    got = G.compact(tp, ta, to, 64)
    _close(got[0], ref[0], "compact params")
    _close(got[1], ref[1], "compact aux")
    assert got[3] == ref[3]

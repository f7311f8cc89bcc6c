"""Port parity of the data-parallel steps (parallel/mesh.py) and a sharded
SLAM run.

- `dp_mapping_iteration` on the JAX package's tiny mapping problem
  (tests/test_parallel.py: 8 slots, one invalid, mixed language and pose
  flags, 24x32 frames, 192^2 language maps) over 8 CPU shards, against
  JAX's on its 8-device CPU mesh (Pallas blend in interpret mode) and
  against the port's single-device `mapping_iteration`.
- `dp_ae_train_step` over 8 CPU shards against JAX's and the port's
  single-device online step.
- smoke.yaml, 8 frames at CPU budgets, with 2 CPU shards (banded tracking,
  sharded mapping) against the same run unsharded.

Tolerances: the JAX package holds its sharded steps to 1e-5; so does the
port against its own single-device step and for the AE against JAX. The
mapping iteration against JAX: 1e-4 relative (1e-6 absolute), as
tests/test_torch_slam.py, since the float sums of the two blends run in
different orders. The sharded SLAM run against the unsharded one: the same
keyframes, tracking iteration counts and Gaussian count, camera centres
within 5e-3 m of each other. One tracked frame differs by ~2e-7 between
the two (the banded loss sums the bands); the map's Adam (eps 1e-15) turns
such rounding noise into lr-sized steps, so 8 frames drift ~2e-3 m apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_helpers import assert_normalized, jax_params_aux, n, numpy_map, t

from online_lang_splatting_tpu.models import autoencoder as jae
from online_lang_splatting_tpu.models import gaussians as JG
from online_lang_splatting_tpu.ops import graphics as jgraphics
from online_lang_splatting_tpu.ops.raster import RasterSettings as JSettings
from online_lang_splatting_tpu.parallel import mesh as jmesh
from online_lang_splatting_tpu_torch import convert
from online_lang_splatting_tpu_torch.convert import gaussians_from_numpy
from online_lang_splatting_tpu_torch.models import autoencoder as ae
from online_lang_splatting_tpu_torch.models import gaussians as G
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings
from online_lang_splatting_tpu_torch.parallel.mesh import (
    dp_ae_train_step, dp_mapping_iteration, named_mesh)
from online_lang_splatting_tpu_torch.slam.backend import mapping_iteration
from online_lang_splatting_tpu_torch.slam.config import load_config
from online_lang_splatting_tpu_torch.slam.system import SLAM

S, W, H, FOCAL = 8, 32, 24, 30.0


def _tiny_mapping_problem():
    """The arrays of tests/test_parallel.py's problem, in numpy."""
    rng = np.random.default_rng(1)
    tree = numpy_map(seed=1, n_pts=96, lang_dim=15, cap=256, depth=3.0, spread=0.5)
    z3, zs = np.zeros((S, 3), np.float32), np.zeros(S, np.float32)
    args = dict(
        slot_r=np.broadcast_to(np.eye(3, dtype=np.float32), (S, 3, 3)).copy(),
        slot_t=(rng.normal(size=(S, 3)) * 0.01).astype(np.float32),
        slot_ea=(rng.normal(size=S) * 0.01).astype(np.float32),
        slot_eb=(rng.normal(size=S) * 0.01).astype(np.float32),
        pose_m=(z3, z3, zs, zs), pose_v=(z3, z3, zs, zs), pose_t=zs,
        images=rng.uniform(size=(S, 3, H, W)).astype(np.float32),
        depths=np.full((S, 1, H, W), 3.0, np.float32),
        langs=(rng.normal(size=(S, 15, 192, 192)) * 0.1).astype(np.float32),
        slot_valid=np.array([True] * (S - 1) + [False]),
        lang_on=np.array([True, False] + [True] * (S - 2)),
        pose_opt=np.array([False] + [True] * (S - 1)),
        exp_opt=np.ones(S, bool),
        lrs=[np.float32(1e-3)] * 7)
    proj = np.asarray(jgraphics.projection_matrix(0.01, 100.0, W / 2, H / 2, FOCAL, FOCAL,
                                                  W, H), np.float32)
    kw = dict(image_height=H, image_width=W, tanfovx=W / (2 * FOCAL),
              tanfovy=H / (2 * FOCAL), sh_degree=0, tile=16)
    return tree, args, proj, kw


def _jax_args(tree, a, proj):
    jp, ja = jax_params_aux(tree)
    j = {k: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v))
         for k, v in a.items() if k != "lrs"}
    return (jp, JG.init_adam(jp), ja, jnp.asarray(proj), j["slot_r"], j["slot_t"],
            j["slot_ea"], j["slot_eb"], j["pose_m"], j["pose_v"], j["pose_t"], j["images"],
            j["depths"], j["langs"], j["slot_valid"], j["lang_on"], j["pose_opt"],
            j["exp_opt"], JG.LearningRates(*map(jnp.asarray, a["lrs"])), jnp.float32(1.0))


def _torch_args(tree, a, proj):
    tp, ta, to = gaussians_from_numpy(tree)
    return (tp, to, ta, t(proj), t(a["slot_r"]), t(a["slot_t"]), t(a["slot_ea"]),
            t(a["slot_eb"]), tuple(map(t, a["pose_m"])), tuple(map(t, a["pose_v"])),
            t(a["pose_t"]), list(t(a["images"])), list(t(a["depths"])), list(t(a["langs"])),
            list(a["slot_valid"]), list(a["lang_on"]), a["pose_opt"], t(a["exp_opt"]),
            G.LearningRates(*map(t, a["lrs"])), 1.0)


def _leaves(out):
    """(name, array) of every output of a mapping iteration but the JAX-only
    overflow flag and instance demand."""
    params, opt, aux, r, tt, ea, eb, (pm, pv, pt), occ, loss = out[:10]
    rows = [(f"params.{f}", v) for f, v in zip(G.GaussianParams._fields, params)]
    rows += [(f"mu.{f}", v) for f, v in zip(G.GaussianParams._fields, opt.mu)]
    rows += [(f"nu.{f}", v) for f, v in zip(G.GaussianParams._fields, opt.nu)]
    rows += [(f"aux.{f}", getattr(aux, f)) for f in ("max_radii2d", "xyz_grad_accum", "denom")]
    rows += [("r", r), ("t", tt), ("ea", ea), ("eb", eb), ("pose_t", pt), ("loss", loss)]
    rows += [(f"pose_m{i}", v) for i, v in enumerate(pm)]
    rows += [(f"pose_v{i}", v) for i, v in enumerate(pv)]
    return rows, occ


def test_dp_mapping_iteration_matches_jax_and_single_device():
    tree, a, proj, kw = _tiny_mapping_problem()
    ref = jmesh.dp_mapping_iteration(JSettings(backend="tpu", max_instances=4096, **kw),
                                     jmesh.make_mesh(8), S, False)(*_jax_args(tree, a, proj))
    settings = RasterSettings(**kw)
    got = dp_mapping_iteration(settings, named_mesh(["cpu"] * 8), S, False)(
        *_torch_args(tree, a, proj))
    single = mapping_iteration(*_torch_args(tree, a, proj), settings=settings,
                               init_mode=False)
    (rows_g, occ_g), (rows_s, occ_s), (rows_r, occ_r) = map(_leaves, (got, single, ref))
    for (name, g), (_, s), (_, r) in zip(rows_g, rows_s, rows_r):
        np.testing.assert_allclose(n(g), n(s), rtol=0, atol=1e-5, err_msg=f"{name} vs single")
        np.testing.assert_allclose(n(g), n(r), rtol=1e-4, atol=1e-6, err_msg=f"{name} vs JAX")
    np.testing.assert_array_equal(n(occ_g), n(occ_s))
    np.testing.assert_array_equal(n(occ_g), n(occ_r))
    assert n(occ_g)[:-1].any(axis=1).all() and not n(occ_g)[-1].any()  # invalid slot
    assert not np.allclose(n(got[4])[1], a["slot_t"][1])  # a pose slot moved


def test_dp_ae_train_step_matches_jax_and_single_device():
    jm = jae.EncoderDecoderOnline()
    params = jm.init(jax.random.key(0), jnp.zeros((1, 32)))["params"]
    jopt = jae.make_online_optimizer()
    batch = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    p_ref, _, loss_ref = jmesh.dp_ae_train_step(jm, jopt, jmesh.make_mesh(8))(
        params, jopt.init(params), jnp.asarray(batch))

    def model():
        m = ae.EncoderDecoderOnline()
        m.load_state_dict(convert.language_from_numpy(
            online_ae=jax.tree.map(np.asarray, params))["online_ae"])
        return m

    dp_model, single_model = model(), model()
    loss = dp_ae_train_step(dp_model, ae.make_online_optimizer(dp_model),
                            named_mesh(["cpu"] * 8))(t(batch))
    loss_single = ae.online_train_step(single_model, ae.make_online_optimizer(single_model),
                                       t(batch))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(loss_single), rtol=1e-5)
    want = convert.language_from_numpy(
        online_ae=jax.tree.map(np.asarray, p_ref))["online_ae"]
    single = single_model.state_dict()
    for k, v in dp_model.state_dict().items():
        assert_normalized(v, want[k], 1e-5, f"{k} vs JAX")
        assert_normalized(v, single[k], 1e-5, f"{k} vs single")
        assert not torch.equal(v, model().state_dict()[k]), k  # the step moved it


def test_sharded_smoke_run_matches_unsharded():
    runs = []
    for mesh in (None, named_mesh(["cpu", "cpu"])):
        cfg = load_config("configs/synthetic/smoke.yaml")
        cfg["raster_tile"] = 16
        cfg["Training"].update(init_itr_num=15, mapping_itr_num=5, tracking_itr_num=10)
        slam = SLAM(cfg, device="cpu", mesh=mesh)
        runs.append(slam.run(max_frames=8))
    single, sharded = runs
    assert sharded.backend.mesh is not None and sharded.frontend.mesh is not None
    assert sharded.backend._n_slots() % 2 == 0
    fe_s, fe_d = single.frontend, sharded.frontend
    assert fe_d.kf_indices == fe_s.kf_indices and len(fe_s.kf_indices) >= 2
    assert fe_d.track_iters == fe_s.track_iters
    assert int(sharded.backend.aux.active.sum()) == int(single.backend.aux.active.sum())
    drift = max(np.linalg.norm(fe_d.cameras[i].r.T @ fe_d.cameras[i].t
                               - fe_s.cameras[i].r.T @ fe_s.cameras[i].t)
                for i in fe_s.cameras)
    assert drift < 5e-3, drift
    errs = [np.linalg.norm(c.t - c.t_gt) for c in fe_d.cameras.values()]
    assert np.median(errs) < 0.15

"""Port parity of colour refinement, the SLAM snapshot and the PLY files.

* Refinement: three iterations of `color_refine` at smoke size (tile 16,
  anisotropic rotated splats, since Adam's eps 1e-15 turns rounding-noise
  gradients into lr-sized steps) against the JAX package's, within the
  mapping-iteration parity test's tolerance (rtol 1e-4, atol 1e-6; the JAX
  side renders through its dense oracle, the port through the plain
  versions of its blend kernels).
* Snapshot: the port's save -> load -> save is exact, a resumed run on the
  CPU ends bit for bit where the uninterrupted run ends, and a snapshot the
  JAX package wrote loads into the port with bitwise-equal tensors.
* PLY: each package reads the other's Gaussian snapshot exactly.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import jax_params_aux, map_from_frame, n, t

from online_lang_splatting_tpu.models import gaussians as JG
from online_lang_splatting_tpu.ops import graphics as jgraphics
from online_lang_splatting_tpu.ops.raster import RasterSettings as JSettings
from online_lang_splatting_tpu.slam import camera as jcamera
from online_lang_splatting_tpu.slam import checkpoint as jcheckpoint
from online_lang_splatting_tpu.slam import refinement as jrefinement
from online_lang_splatting_tpu.slam.system import SLAM as JSLAM
from online_lang_splatting_tpu.utils import ply as jply
from online_lang_splatting_tpu_torch.convert import gaussians_from_numpy
from online_lang_splatting_tpu_torch.models import gaussians as G
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings
from online_lang_splatting_tpu_torch.slam import checkpoint, datasets, refinement
from online_lang_splatting_tpu_torch.slam.config import load_config
from online_lang_splatting_tpu_torch.slam.system import SLAM
from online_lang_splatting_tpu_torch.utils import ply

SMOKE = "configs/synthetic/smoke.yaml"


def _small_config():
    cfg = load_config(SMOKE)
    cfg["raster_tile"] = 16
    cfg["Training"].update(init_itr_num=12, tracking_itr_num=8, mapping_itr_num=4)
    return cfg


def test_color_refine_matches_jax():
    cfg = load_config(SMOKE)
    ds = datasets.SyntheticDataset(cfg)
    tree = map_from_frame(ds, seed=2)
    jp, ja = jax_params_aux(tree)
    tp, ta, _ = gaussians_from_numpy(tree)
    rng = np.random.default_rng(4)
    kfs = {}
    for k in (0, 2, 4):
        color, _, w2c, _, _ = ds[k]
        kfs[k] = (color, w2c[:3, :3].astype(np.float32),
                  (w2c[:3, 3] + rng.normal(size=3) * 0.002).astype(np.float32))
    w, h = ds.width, ds.height
    kw = dict(image_height=h, image_width=w, tanfovx=np.tan(ds.fovx / 2),
              tanfovy=np.tan(ds.fovy / 2), sh_degree=0, tile=16)
    proj = n(jgraphics.projection_matrix(0.01, 100.0, ds.cx, ds.cy, ds.fx, ds.fy, w, h))
    ref = jrefinement.color_refine(
        jp, ja, {k: types.SimpleNamespace(image=jnp.asarray(c), r=r, t=tt)
                 for k, (c, r, tt) in kfs.items()},
        jnp.asarray(proj), JSettings(backend="oracle", **kw), iterations=3, lambda_dssim=0.2)
    got = refinement.color_refine(
        tp, ta, {k: types.SimpleNamespace(image=t(c), r=r, t=tt) for k, (c, r, tt) in kfs.items()},
        t(proj), RasterSettings(backend="cuda", **kw), iterations=3, lambda_dssim=0.2)
    assert len(got[2]) == 3 and float(got[2][-1]) < float(got[2][0])
    for f, g, e in zip(JG.GaussianParams._fields, got[0], ref[0]):
        np.testing.assert_allclose(n(g), n(e), rtol=1e-4, atol=1e-6, err_msg=f"params.{f}")
    for what, gs, es in (("mu", got[1].mu, ref[1].mu), ("nu", got[1].nu, ref[1].nu)):
        for f, g, e in zip(JG.GaussianParams._fields, gs, es):
            np.testing.assert_allclose(n(g), n(e), rtol=1e-4, atol=1e-6, err_msg=f"{what}.{f}")
    assert int(got[1].count) == int(ref[1].count) == 3
    assert not np.allclose(n(got[0].xyz), tree["xyz"])  # the map moved


def _snapshot_equal(a_path, b_path, skip=()):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k not in skip:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_snapshot_round_trip_and_bitwise_resume(tmp_path):
    cfg = _small_config()
    full = SLAM(cfg, device="cpu", save_dir=tmp_path / "run")
    full.run(max_frames=9, checkpoint_every=3)
    ckpts = sorted((tmp_path / "run").glob("ckpt_*.npz"))
    assert ckpts, "no snapshot taken"
    first = ckpts[0]

    resumed = SLAM(cfg, device="cpu")
    start = checkpoint.load_state(resumed, first)
    assert start == int(first.stem[5:]) + 1 < 9
    checkpoint.save_state(resumed, tmp_path / "again.npz", start)
    # Tracked poses of frames the snapshot did not hold are not in it.
    _snapshot_equal(first, tmp_path / "again.npz")

    resumed.run(max_frames=9, start_frame=start)
    be, rb = full.backend, resumed.backend
    for f in G.GaussianParams._fields:
        assert torch.equal(getattr(rb.params, f), getattr(be.params, f)), f
        assert torch.equal(getattr(rb.opt.mu, f), getattr(be.opt.mu, f)), f
    for f in G.GaussianAux._fields:
        assert torch.equal(getattr(rb.aux, f), getattr(be.aux, f)), f
    assert rb.iteration_count == be.iteration_count
    assert torch.equal(rb.generator.get_state(), be.generator.get_state())
    assert resumed.frontend.kf_indices == full.frontend.kf_indices
    for i in range(start, 9):
        np.testing.assert_array_equal(resumed.frontend.cameras[i].r, full.frontend.cameras[i].r)
        np.testing.assert_array_equal(resumed.frontend.cameras[i].t, full.frontend.cameras[i].t)


def test_jax_snapshot_loads_into_port(tmp_path, capsys):
    """A snapshot the JAX package wrote (its own save_state on a state set
    by hand, so no JAX SLAM program compiles) loads with bitwise-equal
    tensors."""
    cfg = load_config(SMOKE)
    cfg["Dataset"]["prefetch"] = False
    js = JSLAM(cfg)
    rng = np.random.default_rng(7)
    tree = map_from_frame(datasets.SyntheticDataset(cfg), cap=cfg["capacity"], seed=3)
    jp, ja = jax_params_aux(tree)
    jb, jf = js.backend, js.frontend
    jb.params = jp
    jb.aux = ja._replace(kf_id=jnp.asarray(rng.integers(0, 5, cfg["capacity"]), jnp.int32),
                         denom=jnp.asarray(rng.uniform(size=cfg["capacity"]), jnp.float32))
    jb.opt = JG.AdamState(
        mu=JG.GaussianParams(*(jnp.asarray(rng.normal(size=x.shape), jnp.float32) for x in jp)),
        nu=JG.GaussianParams(*(jnp.asarray(rng.uniform(size=x.shape), jnp.float32) for x in jp)),
        count=jnp.int32(37))
    jb.keyframe_optimizer_state = (
        tuple(jnp.asarray(rng.normal(size=s), jnp.float32) for s in ((6, 3), (6, 3), (6,), (6,))),
        tuple(jnp.asarray(rng.uniform(size=s), jnp.float32) for s in ((6, 3), (6, 3), (6,), (6,))),
        jnp.full((6,), 12.0, jnp.float32))
    jb.iteration_count = 60
    for i in range(5):
        cam = jcamera.Camera.from_dataset(js.dataset, i)
        cam.update_rt(cam.r_gt, cam.t_gt + rng.normal(size=3).astype(np.float32) * 0.01)
        jf.cameras[i] = cam
        if i in (0, 2, 4):
            cam.exposure_a, cam.exposure_b = float(rng.normal()), float(rng.normal())
            cam.gt_lang_feat = jnp.asarray(rng.normal(size=(15, 192, 192)), jnp.float32)
            jb.viewpoints[i] = cam
            jb.occ_aware_visibility[i] = rng.uniform(size=cfg["capacity"]) > 0.5
    jb.current_window = [4, 2, 0]
    jf.kf_indices = [0, 2, 4]
    jf.median_depth = 3.25
    path = tmp_path / "jax.npz"
    jcheckpoint.save_state(js, path, 5)

    port = SLAM(cfg, device="cpu")
    assert checkpoint.load_state(port, path) == 5
    assert "restart from seed 0" in capsys.readouterr().out
    be, fe = port.backend, port.frontend
    with np.load(path) as data:
        for f in G.GaussianParams._fields:
            for tree_name, got in (("params", be.params), ("opt/mu", be.opt.mu),
                                   ("opt/nu", be.opt.nu)):
                ref = data[f"{tree_name}/{f}"]
                assert getattr(got, f).dtype == torch.as_tensor(ref).dtype
                np.testing.assert_array_equal(n(getattr(got, f)), ref)
        for f in G.GaussianAux._fields:
            np.testing.assert_array_equal(n(getattr(be.aux, f)), data[f"aux/{f}"])
        assert int(be.opt.count) == 37 and be.iteration_count == 60
        for j in range(2):
            for i in range(4):
                np.testing.assert_array_equal(n(be.keyframe_optimizer_state[j][i]),
                                              data[f"kf_opt/{j}/{i}"])
        np.testing.assert_array_equal(n(be.keyframe_optimizer_state[2]), data["kf_opt/2"])
        for i in (0, 2, 4):
            cam = be.viewpoints[i]
            np.testing.assert_array_equal(cam.r, data[f"cam/{i}/r"])
            np.testing.assert_array_equal(cam.t, data[f"cam/{i}/t"])
            assert [cam.exposure_a, cam.exposure_b] == list(data[f"cam/{i}/exposure"])
            np.testing.assert_array_equal(n(be.frame_stack.langs[i]), data[f"cam/{i}/lang"])
            np.testing.assert_array_equal(be.occ_aware_visibility[i], data[f"occ/{i}"])
        for i in range(5):
            rt = data[f"traj/{i}"]
            np.testing.assert_array_equal(fe.cameras[i].r.reshape(-1), rt[:9])
            np.testing.assert_array_equal(fe.cameras[i].t, rt[9:])
    assert be.current_window == [4, 2, 0] and fe.kf_indices == [0, 2, 4]
    assert fe.median_depth == 3.25 and be.initialized
    assert sorted(be.frame_stack.images) == [0, 2, 4]


def test_ply_read_across_packages(tmp_path):
    tree = map_from_frame(datasets.SyntheticDataset(load_config(SMOKE)), seed=5)
    jp, ja = jax_params_aux(tree)
    tp, ta, _ = gaussians_from_numpy(tree)
    n_active = int(tree["active"].sum())
    # The port writes, the JAX package reads, and the other way round.
    ply.save_gaussians_ply(tmp_path / "port.ply", tp, ta)
    jply.save_gaussians_ply(tmp_path / "jax.ply", jp, ja)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    a, b = jply.read_ply(tmp_path / "port.ply"), ply.read_ply(tmp_path / "jax.ply")
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])
    jpar, jaux = jply.load_gaussians_ply(tmp_path / "port.ply")
    tpar, taux = ply.load_gaussians_ply(tmp_path / "jax.ply")
    assert tpar.xyz.shape[0] == jpar.xyz.shape[0] == 1024
    for f in G.GaussianParams._fields:
        np.testing.assert_array_equal(n(getattr(tpar, f)), n(getattr(jpar, f)))
        np.testing.assert_array_equal(n(getattr(tpar, f))[:n_active],
                                      n(getattr(tp, f))[tree["active"]])
    np.testing.assert_array_equal(n(taux.active), n(jaux.active))


def test_threaded_mode_refuses_snapshots():
    slam = SLAM(dict(_small_config(), Training=dict(_small_config()["Training"],
                                                     single_thread=False)), device="cpu")
    with pytest.raises(ValueError, match="single-thread"):
        slam.run(max_frames=3, checkpoint_every=2)

"""Port parity of the SLAM slice: the synthetic dataset, the gradient
mask, back-projection, a 10-iteration tracking run, one 3-slot mapping
iteration, and an 8-frame end-to-end run of the port on smoke.yaml.

Tracking: pose atol 1e-4, equal iteration count. Mapping: rtol 1e-4 (the
JAX side renders through its dense oracle, the port through the plain
versions of its blend kernels, so float sums run in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import jax_params_aux, n, t

from online_lang_splatting_tpu.models import gaussians as JG
from online_lang_splatting_tpu.ops import graphics as jgraphics
from online_lang_splatting_tpu.ops.raster import RasterSettings as JSettings
from online_lang_splatting_tpu.slam import backend as jbackend
from online_lang_splatting_tpu.slam import camera as jcamera
from online_lang_splatting_tpu.slam import datasets as jdatasets
from online_lang_splatting_tpu.slam import frontend as jfrontend
from online_lang_splatting_tpu.slam import renderer as jrenderer
from online_lang_splatting_tpu.slam.config import load_config as jload_config
from online_lang_splatting_tpu_torch.convert import cameras_from_numpy, gaussians_from_numpy
from online_lang_splatting_tpu_torch.models import gaussians as G
from online_lang_splatting_tpu_torch.ops import graphics
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings
from online_lang_splatting_tpu_torch.slam import backend, camera, datasets, frontend, renderer
from online_lang_splatting_tpu_torch.slam.config import load_config
from online_lang_splatting_tpu_torch.slam.system import SLAM

SMOKE = "configs/synthetic/smoke.yaml"


@pytest.fixture(scope="module")
def smoke():
    cfg = load_config(SMOKE)
    assert cfg == jload_config(SMOKE)
    ds = datasets.SyntheticDataset(cfg)
    jds = jdatasets.SyntheticDataset(cfg)
    calib = cfg["Dataset"]["Calibration"]
    w, h = calib["width"], calib["height"]
    proj = n(graphics.projection_matrix(0.01, 100.0, ds.cx, ds.cy, ds.fx, ds.fy, w, h))
    np.testing.assert_array_equal(
        proj, n(jgraphics.projection_matrix(0.01, 100.0, ds.cx, ds.cy, ds.fx, ds.fy, w, h)))
    return cfg, ds, jds, proj


def _map_from_frame(ds, frame=0, n_pts=400, cap=1024, seed=0):
    """A numpy map back-projected from a frame: every field in the JAX
    package's layout."""
    rng = np.random.default_rng(seed)
    color, depth, w2c, _, _ = ds[frame]
    ys, xs = np.nonzero(depth > 0)
    pick = rng.choice(len(ys), n_pts, replace=False)
    ys, xs = ys[pick], xs[pick]
    z = depth[ys, xs]
    cam = np.stack([(xs - ds.cx) / ds.fx * z, (ys - ds.cy) / ds.fy * z, z], -1)
    c2w = np.linalg.inv(w2c.astype(np.float64))
    world = cam @ c2w[:3, :3].T + c2w[:3, 3]
    tree = dict(
        xyz=np.zeros((cap, 3), np.float32), features_dc=np.zeros((cap, 1, 3), np.float32),
        features_rest=np.zeros((cap, 0, 3), np.float32),
        scaling=np.zeros((cap, 3), np.float32), rotation=np.zeros((cap, 4), np.float32),
        opacity=np.full((cap, 1), -9.21, np.float32),
        language=np.zeros((cap, 15), np.float32), active=np.zeros(cap, bool))
    tree["rotation"][:, 0] = 1.0
    tree["xyz"][:n_pts] = world
    tree["features_dc"][:n_pts, 0] = (color[:, ys, xs].T - 0.5) / 0.28209479177387814
    # Anisotropic, rotated splats: with isotropic ones the rotation gradient
    # is analytically zero and Adam would turn rounding noise into lr-sized
    # steps.
    tree["scaling"][:n_pts] = np.log(0.012 * z[:, None] * rng.uniform(0.5, 1.5, (n_pts, 3)))
    q = rng.normal(size=(n_pts, 4))
    tree["rotation"][:n_pts] = q / np.linalg.norm(q, axis=1, keepdims=True)
    tree["opacity"][:n_pts] = 1.5
    tree["language"][:n_pts] = rng.normal(size=(n_pts, 15)) * 0.2
    tree["active"][:n_pts] = True
    return tree


def test_synthetic_dataset_grad_mask_and_backprojection(smoke):
    cfg, ds, jds, _ = smoke
    assert len(ds) == len(jds)
    for idx in (0, 5):
        for a, b in zip(ds[idx][:3], jds[idx][:3]):
            np.testing.assert_array_equal(a, b)
    # A continuous texture: on the synthetic frames the median Scharr
    # intensity is float rounding noise (~1e-8, piecewise-constant texture),
    # so there the mask hinges on the last bit of each framework's
    # convolution and differs in ~1% of pixels between JAX and the port.
    image = np.random.default_rng(3).uniform(size=(3, ds.height, ds.width)).astype(np.float32)
    et = float(cfg["Training"]["edge_threshold"])
    got = camera._grad_mask_device(t(image), False, 32, 32, et)
    ref = jcamera._grad_mask_device(jnp.asarray(image), False, 32, 32, jnp.float32(et))
    np.testing.assert_array_equal(n(got), n(ref))
    got = camera._grad_mask_device(t(image), True, 4, 4, et)
    ref = jcamera._grad_mask_device(jnp.asarray(image), True, 4, 4, jnp.float32(et))
    np.testing.assert_array_equal(n(got), n(ref))

    color, depth, w2c, _, _ = ds[2]
    depth = depth.copy()
    depth[:5] = 0.0  # invalid pixels are never picked
    intr = (ds.fx, ds.fy, ds.cx, ds.cy)
    key = jax.random.PRNGKey(11)
    ref = jbackend.backproject_sample(jnp.asarray(color), jnp.asarray(depth), jnp.asarray(w2c),
                                      jnp.asarray(intr, jnp.float32), key, 500)
    uniform = t(n(jax.random.uniform(key, (depth.size,))))
    got = backend.backproject_sample(t(color), t(depth), t(w2c), intr, uniform, 500)
    np.testing.assert_allclose(n(got[0]), n(ref[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(got[1]), n(ref[1]))
    np.testing.assert_array_equal(n(got[2]), n(ref[2]))


def test_tracking_run_matches_jax(smoke):
    cfg, ds, jds, proj = smoke
    tree = _map_from_frame(ds)
    jp, ja = jax_params_aux(tree)
    tp, ta, _ = gaussians_from_numpy(tree)
    color, depth, w2c, _, _ = ds[1]
    _, _, w2c0, _, _ = ds[0]
    gmask = n(jcamera._grad_mask_device(jnp.asarray(color), False, 32, 32, jnp.float32(4.0)))
    tr = cfg["Training"]
    w, h = ds.width, ds.height
    jset = JSettings(image_height=h, image_width=w, tanfovx=np.tan(ds.fovx / 2),
                     tanfovy=np.tan(ds.fovy / 2), sh_degree=0, backend="oracle", tile=32)
    tset = RasterSettings(image_height=h, image_width=w, tanfovx=np.tan(ds.fovx / 2),
                          tanfovy=np.tan(ds.fovy / 2), sh_degree=0, backend="cuda", tile=32)
    lrs = (np.float32(tr["lr"]["cam_trans_delta"]), np.float32(tr["lr"]["cam_rot_delta"]),
           np.float32(0.01))
    ref = jfrontend.tracking_run(
        jrenderer.activate(jp, ja.active), jnp.asarray(w2c0), jnp.asarray(proj),
        jnp.asarray(color), jnp.asarray(depth)[None], jnp.asarray(gmask), np.float32(0.0),
        np.float32(0.0), lrs, np.float32(0.0), np.float32(1.0), settings=jset, max_iters=10,
        rgb_threshold=tr["rgb_boundary_threshold"])
    got = frontend.tracking_run(
        renderer.activate(tp, ta.active), t(w2c0), t(proj), t(color), t(depth)[None],
        t(gmask), 0.0, 0.0, lrs, settings=tset, max_iters=10,
        rgb_threshold=tr["rgb_boundary_threshold"])
    assert got[3] == int(ref[3]) == 10
    np.testing.assert_allclose(n(got[0]), n(ref[0]), atol=1e-4)
    np.testing.assert_allclose([float(got[1]), float(got[2])], [float(ref[1]), float(ref[2])],
                               atol=1e-4)
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-4)
    np.testing.assert_allclose(float(got[5]), float(ref[5]), rtol=1e-4)
    np.testing.assert_array_equal(n(got[6]), n(ref[6]))
    assert np.abs(n(got[0]) - w2c0).max() > 1e-3  # the pose did move


def test_mapping_iteration_matches_jax(smoke):
    _, ds, _, proj = smoke
    rng = np.random.default_rng(5)
    tree = _map_from_frame(ds, seed=1)
    jp, ja = jax_params_aux(tree)
    jo = JG.init_adam(jp)
    tp, ta, to = gaussians_from_numpy(tree)
    frames = [ds[i] for i in (0, 2, 4)]
    s = 3
    slot_r = np.stack([f[2][:3, :3] for f in frames]).astype(np.float32)
    slot_t = (np.stack([f[2][:3, 3] for f in frames])
              + rng.normal(size=(s, 3)) * 0.003).astype(np.float32)
    slot_ea = (rng.normal(size=s) * 0.02).astype(np.float32)
    slot_eb = (rng.normal(size=s) * 0.02).astype(np.float32)
    images = np.stack([f[0] for f in frames])
    depths = np.stack([f[1][None] for f in frames])
    langs = (rng.normal(size=(s, 15, 24, 24)) * 0.1).astype(np.float32)
    valid = np.array([True, True, True])
    lang_on = np.array([True, False, True])
    pose_opt = np.array([False, True, True])
    exp_opt = np.array([True, True, False])
    pm = tuple(np.zeros(sh, np.float32) for sh in ((s, 3), (s, 3), (s,), (s,)))
    pv = tuple(np.full(sh, 1e-6, np.float32) for sh in ((s, 3), (s, 3), (s,), (s,)))
    pt = np.full(s, 2.0, np.float32)
    lrs = [np.float32(x) for x in (1.6e-4, 2.5e-3, 1.25e-4, 1e-3, 1e-3, 5e-2, 2.5e-3)]
    w, h = ds.width, ds.height
    kw = dict(image_height=h, image_width=w, tanfovx=np.tan(ds.fovx / 2),
              tanfovy=np.tan(ds.fovy / 2), sh_degree=0, tile=32)
    ref = jbackend.mapping_iteration(
        jp, jo, ja, jnp.asarray(proj), *map(jnp.asarray, (slot_r, slot_t, slot_ea, slot_eb)),
        tuple(map(jnp.asarray, pm)), tuple(map(jnp.asarray, pv)), jnp.asarray(pt),
        *map(jnp.asarray, (images, depths, langs, valid, lang_on, pose_opt, exp_opt)),
        JG.LearningRates(*map(jnp.asarray, lrs)), jnp.float32(1.0),
        settings=JSettings(backend="oracle", **kw), n_slots=s, init_mode=False)
    got = backend.mapping_iteration(
        tp, to, ta, t(proj), *map(t, (slot_r, slot_t, slot_ea, slot_eb)),
        tuple(map(t, pm)), tuple(map(t, pv)), t(pt), list(t(images)), list(t(depths)),
        list(t(langs)), list(valid), list(lang_on), pose_opt, t(exp_opt),
        G.LearningRates(*map(t, lrs)), 1.0,
        settings=RasterSettings(backend="cuda", **kw), init_mode=False)

    def close(g, e, what):
        np.testing.assert_allclose(n(g), n(e), rtol=1e-4, atol=1e-6, err_msg=what)

    for f, g, e in zip(JG.GaussianParams._fields, got[0], ref[0]):
        close(g, e, f"params.{f}")
    for f, g, e in zip(JG.GaussianParams._fields, got[1].mu, ref[1].mu):
        close(g, e, f"mu.{f}")
    for f, g, e in zip(JG.GaussianParams._fields, got[1].nu, ref[1].nu):
        close(g, e, f"nu.{f}")
    for f in ("max_radii2d", "xyz_grad_accum", "denom"):
        close(getattr(got[2], f), getattr(ref[2], f), f"aux.{f}")
    for i, what in enumerate(("r", "t", "ea", "eb")):
        close(got[3 + i], ref[3 + i], f"slot {what}")
    for g, e in zip(got[7][0] + got[7][1], ref[7][0] + ref[7][1]):
        close(g, e, "pose moments")
    np.testing.assert_array_equal(n(got[8]), n(ref[8]))
    close(got[9], ref[9], "loss")
    assert not np.allclose(n(got[3 + 1])[1], slot_t[1])  # the pose slot moved


def test_smoke_run_end_to_end():
    """The port's SLAM on smoke.yaml, 8 frames on the CPU, with the gates of
    tests/test_slam_e2e.py. Tile 16 instead of the configured default 32:
    the CPU path's cost grows with tile area (tile 32 is covered by the
    tile-32 goldens here and by chip_smoke.py on the card)."""
    cfg = load_config(SMOKE)
    cfg["raster_tile"] = 16
    slam = SLAM(cfg, device="cpu")
    slam.run_single_thread(max_frames=8)
    fe, be = slam.frontend, slam.backend
    assert len(fe.kf_indices) >= 2 and 0 in fe.kf_indices
    assert int(be.aux.active.sum()) > 100
    errs = [np.linalg.norm(c.t - c.t_gt) for c in fe.cameras.values()]
    assert np.median(errs) < 0.15
    cam = fe.cameras[0]
    with torch.no_grad():
        out = renderer.render(renderer.activate(be.params, be.aux.active),
                              t(cam.world_view_transform), slam.proj, slam.settings)
    assert out.language.shape[0] == 15
    assert torch.isfinite(out.language).all()
    assert set(slam.phase_times) == {"data", "track", "map", "init", "kf_insert"}
    cams = cameras_from_numpy(
        {0: dict(image=cam.image_host, depth=cam.depth, r=cam.r, t=cam.t, r_gt=cam.r_gt,
                 t_gt=cam.t_gt)},
        dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width, height=cam.height))
    np.testing.assert_array_equal(cams[0].world_view_transform, cam.world_view_transform)

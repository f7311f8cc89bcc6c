"""Port parity of the viewers (gui/orbit.py, gui/viewer.py, gui/slam_gui.py):
the seven cases of the JAX package's tests/test_gui.py, each also held to
the JAX function on the same inputs, and the HeadlessViewer's PNG mosaic
against the JAX viewer's.

Tolerances: the numpy functions (orbit camera, frustums, ellipsoid
geometry, thumbnail strip) are copies and match exactly (the orbit matrix
to 1e-6); the mosaic within 1 uint8 level, the JAX viewer rendering through
its dense oracle and the port's through the blend kernels' plain versions.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from torch_helpers import t

from online_lang_splatting_tpu.gui import orbit as jorbit
from online_lang_splatting_tpu.gui import slam_gui as jgui
from online_lang_splatting_tpu.gui import viewer as jviewer
from online_lang_splatting_tpu.ops import graphics as jgraphics
from online_lang_splatting_tpu.ops.raster import RasterSettings as JSettings
from online_lang_splatting_tpu.slam.renderer import RenderInputs as JInputs
from online_lang_splatting_tpu_torch.gui import orbit, slam_gui, viewer
from online_lang_splatting_tpu_torch.gui.viewer import GaussianPacket, HeadlessViewer
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings
from online_lang_splatting_tpu_torch.slam.config import load_config
from online_lang_splatting_tpu_torch.slam.renderer import RenderInputs
from online_lang_splatting_tpu_torch.slam.system import SLAM

SMOKE = "configs/synthetic/smoke.yaml"


def _arrays(n=32, seed=0, lang_dim=0):
    rng = np.random.default_rng(seed)
    return dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        opacity=np.where(np.arange(n) % 4 == 0, 0.01, 0.8).astype(np.float32),
        scales=rng.uniform(0.01, 0.2, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        shs=(rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32),
        language=np.zeros((n, lang_dim), np.float32))


def test_ellipsoid_geometry_filters_and_colors():
    arrays = _arrays(32)
    got = slam_gui.ellipsoid_geometry(RenderInputs(**{k: t(v) for k, v in arrays.items()}))
    ref = jgui.ellipsoid_geometry(JInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    xyz, rgb, scales, quats = got
    assert len(xyz) == 24  # opacity <= 0.05 filtered (8 of 32)
    assert rgb.shape == (24, 3) and rgb.min() >= 0 and rgb.max() <= 1
    assert scales.shape == (24, 3) and quats.shape == (24, 4)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_interactive_gui_falls_back_headless(tmp_path):
    """Without open3d, use_gui: "interactive" degrades to the HeadlessViewer."""
    try:
        import open3d  # noqa: F401

        pytest.skip("open3d present; the fallback is not reachable")
    except ImportError:
        pass
    cfg = load_config(SMOKE)
    cfg["Results"]["use_gui"] = "interactive"
    slam = SLAM(cfg, device="cpu", save_dir=tmp_path)
    assert isinstance(slam.viewer, HeadlessViewer)
    assert slam.viewer.out_dir == tmp_path / "viewer"
    slam.close()
    assert slam.viewer is None


def test_gui_pause_protocol():
    slam = SLAM(load_config(SMOKE), device="cpu")
    # A pause followed by a resume already queued: both are consumed and the
    # loop goes on (no deadlock).
    slam.q_vis2main.put(slam_gui.Packet_vis2main(flag_pause=True))
    slam.q_vis2main.put(slam_gui.Packet_vis2main(flag_pause=False))
    slam._check_gui_pause()
    assert slam._gui_paused is False
    assert slam.q_vis2main.empty()
    slam.close()


def _moved_orbits():
    cams = []
    for mod in (orbit, jorbit):
        cam = mod.OrbitCamera(target=(0.5, -0.2, 3.0), radius=2.0)
        cam.rotate(0.7, 0.3)
        cam.zoom(1.5)
        cam.pan(0.2, -0.1)
        cams.append(cam)
    return cams


def test_orbit_camera_view_matrix_orthonormal():
    cam, jcam = _moved_orbits()
    v = cam.view_matrix()
    r = v[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
    assert np.linalg.det(r) > 0.99
    # The target projects onto the optical axis at positive depth.
    t_cam = r @ cam.target + v[:3, 3]
    assert t_cam[2] > 0
    np.testing.assert_allclose(t_cam[:2], 0.0, atol=1e-6)
    np.testing.assert_allclose(np.abs(t_cam[2]), cam.radius, atol=1e-6)
    np.testing.assert_allclose(v, jcam.view_matrix(), atol=1e-6)
    np.testing.assert_array_equal(cam.eye(), jcam.eye())


def test_orbit_camera_elevation_clamped():
    for mod in (orbit, jorbit):
        cam = mod.OrbitCamera()
        cam.rotate(0.0, 10.0)
        assert cam.elevation < np.pi / 2
        high = cam.elevation
        cam.rotate(0.0, -20.0)
        assert cam.elevation > -np.pi / 2
        assert (high, cam.elevation) == (np.pi / 2 - 1e-3, -(np.pi / 2 - 1e-3))


def test_frustum_overlay_draws_visible_keyframes():
    kf = np.eye(4)
    pts = orbit.frustum_points(kf, 0.5, 0.4, scale=0.2)
    assert pts.shape == (5, 3)
    np.testing.assert_allclose(pts[0], 0.0, atol=1e-9)  # apex = camera centre
    np.testing.assert_array_equal(pts, jorbit.frustum_points(kf, 0.5, 0.4, scale=0.2))
    np.testing.assert_array_equal(orbit.FRUSTUM_LINES, jorbit.FRUSTUM_LINES)
    cam = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, tanfovx=0.5, tanfovy=0.4)
    viewer_w2c = np.eye(4)
    viewer_w2c[2, 3] = 2.0  # world origin at z = +2 in the viewer's frame
    kf2 = np.eye(4)
    kf2[0, 3] = 0.3
    img, ref = np.zeros((48, 64, 3)), np.zeros((48, 64, 3))
    orbit.draw_frustums(img, viewer_w2c, [kf, kf2], **cam)
    jorbit.draw_frustums(ref, viewer_w2c, [kf, kf2], **cam)
    assert img.sum() > 0, "the overlay drew nothing"
    np.testing.assert_array_equal(img, ref)
    # A keyframe behind the viewer is skipped.
    kf_behind = np.eye(4)
    kf_behind[2, 3] = 10.0
    img2 = np.zeros((48, 64, 3))
    orbit.draw_frustums(img2, np.eye(4), [kf_behind], **cam)
    assert img2.sum() == 0


def _gt_packet(cls, conv, seed=0):
    rng = np.random.default_rng(seed)
    return cls(gtcolor=conv(rng.uniform(0, 1, (3, 24, 32)).astype(np.float32)),
               gtdepth=rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32),
               gtlanguage=conv(rng.normal(size=(15, 12, 16)).astype(np.float32)))


def test_gt_thumbnail_strip():
    """gt colour / depth / language thumbnails as a side strip; the colour
    and language maps as tensors, as the SLAM loop hands them over."""
    strip = viewer.gt_thumbnail_strip(_gt_packet(GaussianPacket, t), 96)
    assert strip.shape[0] == 96 and strip.shape[2] == 3
    assert np.isfinite(strip).all() and strip.max() <= 1.0 + 1e-9
    for i in range(3):  # all three thumbnails present
        assert strip[i * 32:(i + 1) * 32].std() > 0
    ref = jviewer.gt_thumbnail_strip(_gt_packet(jviewer.GaussianPacket, jnp.asarray), 96)
    np.testing.assert_array_equal(strip, ref)
    assert viewer.gt_thumbnail_strip(GaussianPacket(), 96) is None


def _wait_for(path, timeout=60.0):
    t0 = time.time()
    while not path.exists() and time.time() - t0 < timeout:
        time.sleep(0.05)


def test_headless_viewer_mosaic_matches_jax(tmp_path):
    h, w, f, n_pts = 48, 64, 60.0, 200
    rng = np.random.default_rng(3)
    arrays = _arrays(n_pts, seed=3, lang_dim=8)
    arrays["xyz"][:, 2] = rng.uniform(2.0, 5.0, n_pts)
    arrays["opacity"][:] = rng.uniform(0.3, 0.95, n_pts)
    arrays["quats"] /= np.linalg.norm(arrays["quats"], axis=1, keepdims=True)
    arrays["language"] = rng.normal(size=(n_pts, 8)).astype(np.float32)
    proj = np.asarray(jgraphics.projection_matrix(0.01, 100.0, w / 2, h / 2, f, f, w, h),
                      np.float32)
    kw = dict(image_height=h, image_width=w, tanfovx=w / (2 * f), tanfovy=h / (2 * f),
              sh_degree=0, tile=16)
    view = np.eye(4, dtype=np.float32)
    gt = dict(gtcolor=rng.uniform(0, 1, (3, h, w)).astype(np.float32),
              gtdepth=rng.uniform(0.5, 3.0, (h, w)).astype(np.float32),
              gtlanguage=rng.normal(size=(8, 12, 16)).astype(np.float32))
    pngs = []
    for name, mod, packet in (
            ("jax", jviewer, jviewer.GaussianPacket(
                render_inputs=JInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                view=view, proj=jnp.asarray(proj),
                settings=JSettings(backend="oracle", **kw), frame_idx=3, **gt)),
            ("port", viewer, GaussianPacket(
                render_inputs=RenderInputs(**{k: t(v) for k, v in arrays.items()}),
                view=view, proj=t(proj), settings=RasterSettings(**kw), frame_idx=3,
                **{k: t(v) for k, v in gt.items()}))):
        v = mod.HeadlessViewer(str(tmp_path / name), every=1)
        v.submit(packet)
        path = tmp_path / name / "frame_00003.png"
        _wait_for(path)
        v.close()
        assert not v._thread.is_alive()
        pngs.append(np.asarray(Image.open(path)).astype(np.int32))
    ref, got = pngs
    assert got.shape == ref.shape and got.shape[0] == h and got.shape[2] == 3
    assert got.shape[1] > 5 * w  # 5 panels and the thumbnail strip
    assert int(np.abs(got - ref).max()) <= 1
    assert got[:, w:2 * w].std() > 10  # the colour panel is not blank

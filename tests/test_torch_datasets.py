"""Port parity of the disk datasets, the frame decoders and prefetch.

Small trees on disk from the smoke scene, written as the JAX package's
tests/test_dataset_e2e.py writes them (PNG by PIL): Replica-v2, TUM,
Replica-v1 (JPEG colour), a EuRoC stereo pair, a `distorted` Replica-v2
config and per-frame language labels. The port's `__getitem__` must equal
the JAX package's exactly (colour, depth, pose, labels), and so must the
port's zlib decoder (the card's machine has no libpng headers) equal its
libpng decoder, on PIL's files and on the port's PNG writer's, which
uses all five PNG filter types.
"""

import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from torch_helpers import t  # noqa: F401  (sets the torch thread count)

from online_lang_splatting_tpu.slam import datasets as jdatasets
from online_lang_splatting_tpu_torch import native
from online_lang_splatting_tpu_torch.slam import datasets
from online_lang_splatting_tpu_torch.slam.config import load_config
from online_lang_splatting_tpu_torch.slam.prefetch import CameraPrefetcher, PrefetchDataset

REPO = Path(__file__).resolve().parents[1]
N_FRAMES = 4
DEPTH_SCALE = 5000.0
LAYOUTS = ("replicav2", "tum", "replica", "euroc", "distorted")


def _frames():
    cfg = load_config("configs/synthetic/smoke.yaml")
    ds = datasets.SyntheticDataset(cfg)
    return cfg, [ds[i][:3] for i in range(N_FRAMES)]


def _rgb_u8(chw):
    return (np.clip(chw, 0, 1).transpose(1, 2, 0) * 255.0).round().astype(np.uint8)


def _depth_u16(depth):
    return np.clip(depth * DEPTH_SCALE, 0, 65535).round().astype(np.uint16)


def _quat(c2w):
    r = c2w[:3, :3]
    w = np.sqrt(max(1.0 + r[0, 0] + r[1, 1] + r[2, 2], 1e-12)) / 2
    return ((r[2, 1] - r[1, 2]) / (4 * w), (r[0, 2] - r[2, 0]) / (4 * w),
            (r[1, 0] - r[0, 1]) / (4 * w), w)


def _write(root, layout, frames):
    """One tree per layout; returns the Dataset config section."""
    data = {"dataset_path": str(root)}
    if layout in ("replicav2", "distorted"):
        (root / "rgb").mkdir(parents=True)
        (root / "depth").mkdir()
        (root / "labels").mkdir()
        lines = []
        for i, (color, depth, pose) in enumerate(frames):
            Image.fromarray(_rgb_u8(color)).save(root / "rgb" / f"rgb_{i}.png")
            Image.fromarray(_depth_u16(depth)).save(root / "depth" / f"depth_{i}.png")
            np.save(root / "labels" / f"{i:04d}_ld.npy",
                    np.random.default_rng(i).normal(size=(15, 8, 8)).astype(np.float32))
            lines.append(" ".join(f"{v:.9f}" for v in pose.reshape(-1)))
        (root / "traj_w_c.txt").write_text("\n".join(lines) + "\n")
        data["type"] = "replicav2"
    elif layout == "tum":
        (root / "rgb").mkdir(parents=True)
        (root / "depth").mkdir()
        rgb_rows, depth_rows, gt_rows = [], [], []
        for i, (color, depth, pose) in enumerate(frames):
            ts = 1000.0 + i
            Image.fromarray(_rgb_u8(color)).save(root / "rgb" / f"{ts:.6f}.png")
            Image.fromarray(_depth_u16(depth)).save(root / "depth" / f"{ts:.6f}.png")
            rgb_rows.append(f"{ts:.6f} rgb/{ts:.6f}.png")
            depth_rows.append(f"{ts:.6f} depth/{ts:.6f}.png")
            c2w = np.linalg.inv(pose.astype(np.float64))
            qx, qy, qz, qw = _quat(c2w)
            tx, ty, tz = c2w[:3, 3]
            gt_rows.append(f"{ts:.6f} {tx:.9f} {ty:.9f} {tz:.9f} {qx:.9f} {qy:.9f} "
                           f"{qz:.9f} {qw:.9f}")
        for name, rows in (("rgb", rgb_rows), ("depth", depth_rows), ("groundtruth", gt_rows)):
            (root / f"{name}.txt").write_text("# header\n" + "\n".join(rows) + "\n")
        data["type"] = "tum"
    elif layout == "replica":
        (root / "results").mkdir(parents=True)
        lines = []
        for i, (color, depth, pose) in enumerate(frames):
            Image.fromarray(_rgb_u8(color)).save(root / "results" / f"frame{i:06d}.jpg",
                                                 quality=90)
            Image.fromarray(_depth_u16(depth)).save(root / "results" / f"depth{i:06d}.png")
            c2w = np.linalg.inv(pose.astype(np.float64))
            lines.append(" ".join(f"{v:.9f}" for v in c2w.reshape(-1)))
        (root / "traj.txt").write_text("\n".join(lines) + "\n")
        data["type"] = "replica"
    else:  # euroc
        for cam in ("cam0", "cam1"):
            (root / "mav0" / cam / "data").mkdir(parents=True)
        (root / "mav0/state_groundtruth_estimate0").mkdir(parents=True)
        rows = []
        for i, (color, _, pose) in enumerate(frames):
            stamp = 1_000_000_000_000 + i * 50_000_000
            gray = _rgb_u8(color).mean(axis=-1).astype(np.uint8)
            Image.fromarray(gray).save(root / "mav0/cam0/data" / f"{stamp}.png")
            Image.fromarray(np.roll(gray, -3, axis=1)).save(root / "mav0/cam1/data" / f"{stamp}.png")
            c2w = np.linalg.inv(pose.astype(np.float64))
            qx, qy, qz, qw = _quat(c2w)
            rows.append(f"{stamp},{c2w[0, 3]},{c2w[1, 3]},{c2w[2, 3]},{qw},{qx},{qy},{qz}")
        (root / "mav0/state_groundtruth_estimate0/data.csv").write_text(
            "#t,x,y,z,qw,qx,qy,qz\n" + "\n".join(rows) + "\n")
        data["type"] = "euroc"
    return data


def _config(base, layout, root):
    import copy

    cfg = copy.deepcopy(base)
    cfg["Dataset"].update(_write(root, layout, _frames()[1]))
    cfg["Dataset"]["Calibration"]["depth_scale"] = DEPTH_SCALE
    if layout == "distorted":
        cfg["Dataset"]["Calibration"].update(distorted=True, k1=0.05, k2=-0.01, p1=0.001)
    if layout == "replicav2":
        cfg["language"].update(labels_from_file=True, lang_label_path=str(root / "labels"))
    return cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = _frames()[0]
    return {layout: _config(base, layout, tmp_path_factory.mktemp(layout))
            for layout in LAYOUTS}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_getitem_matches_jax(trees, layout):
    cfg = trees[layout]
    got, ref = datasets.load_dataset(cfg), jdatasets.load_dataset(cfg)
    assert type(got).__name__ == type(ref).__name__
    assert len(got) == len(ref) == N_FRAMES
    np.testing.assert_array_equal(np.stack(got.poses), np.stack(ref.poses))
    for i in range(N_FRAMES):
        for g, r in zip(got[i], ref[i]):
            if r is None:
                assert g is None
            else:
                assert g.dtype == r.dtype
                np.testing.assert_array_equal(g, r)
    if layout == "replicav2":
        assert got[1][3] is not None and got[1][3].shape == (15, 8, 8)


def _filter_types(path, h):
    """The filter-type byte of every row of a one-IDAT PNG."""
    px, _, _ = native.ZlibDecoder().pixels(path)
    stride = px.shape[1] * px.shape[2] * px.dtype.itemsize
    data = open(path, "rb").read()
    raw = zlib.decompressobj().decompress(data[data.index(b"IDAT") + 4:])
    return {raw[y * (stride + 1)] for y in range(h)}


def test_zlib_decoder_matches_libpng_on_every_filter_type(trees, tmp_path):
    """The zlib decoder equals the libpng decoder (and the JAX package's)
    on PIL's PNGs, whose encoder picks filters 1, 2 and 4 here, and on
    the port's writer's (utils/png.py, used by chip_smoke.py), which cycles
    all five; JPEG decodes to libjpeg's samples."""
    from online_lang_splatting_tpu import native as jnative
    from online_lang_splatting_tpu_torch.utils.png import write_png

    root = trees["replicav2"]["Dataset"]["dataset_path"]
    zdec, ldec = native.ZlibDecoder(), native.LibpngDecoder()
    h, w = 64, 96
    color, depth, _ = _frames()[1][1]
    write_png(tmp_path / "rgb.png", _rgb_u8(color))
    write_png(tmp_path / "depth.png", _depth_u16(depth))
    kinds = set()
    for path, kind in [(f"{root}/rgb/rgb_{i}.png", "rgb") for i in range(N_FRAMES)] + [
            (f"{root}/depth/depth_{i}.png", "depth") for i in range(N_FRAMES)] + [
            (tmp_path / "rgb.png", "rgb"), (tmp_path / "depth.png", "depth")]:
        kinds |= _filter_types(path, h)
        if kind == "rgb":
            got = zdec.rgb(path, h, w)
            np.testing.assert_array_equal(got, ldec.rgb(path, h, w))
            np.testing.assert_array_equal(got, jnative.decode_rgb(str(path), h, w))
        else:
            got = zdec.depth(path, h, w, DEPTH_SCALE)
            np.testing.assert_array_equal(got, ldec.depth(path, h, w, DEPTH_SCALE))
            np.testing.assert_array_equal(got, jnative.decode_depth(str(path), h, w,
                                                                    DEPTH_SCALE))
    assert kinds == {0, 1, 2, 3, 4}
    # The writer's values come back exactly.
    np.testing.assert_array_equal(
        zdec.rgb(tmp_path / "rgb.png", h, w),
        _rgb_u8(color).transpose(2, 0, 1).astype(np.float32) * (np.float32(1) / np.float32(255)))
    # JPEG (Replica v1 and the demo image) decodes through PIL in the zlib
    # mode: exactly libjpeg's samples.
    jpg = f"{trees['replica']['Dataset']['dataset_path']}/results/frame000000.jpg"
    for path, (jh, jw) in ((jpg, (h, w)), (REPO / "sample/demo_room.jpg", (680, 1200))):
        got = zdec.rgb(path, jh, jw)
        np.testing.assert_array_equal(got, ldec.rgb(path, jh, jw))
        np.testing.assert_array_equal(got, jnative.decode_rgb(str(path), jh, jw))
    with pytest.raises(RuntimeError, match="size"):
        ldec.rgb(f"{root}/rgb/rgb_0.png", h + 1, w)


def test_prefetch_matches_direct_reads_and_closes(trees):
    import torch

    cfg = trees["replicav2"]
    direct = datasets.load_dataset(cfg)
    before = set(threading.enumerate())
    pre = PrefetchDataset(datasets.load_dataset(cfg))
    cams = CameraPrefetcher(pre, cfg, "cpu")
    for i in range(N_FRAMES):
        for g, r in zip(pre[i], direct[i]):
            np.testing.assert_array_equal(g, r)
        cam = cams.get(i)
        np.testing.assert_array_equal(cam.image.numpy(), direct[i][0])
        assert cam.grad_mask is not None and cam.depth_dev is not None
    assert pre.fx == direct.fx and len(pre) == len(direct)
    cams.close()
    pre.close()
    assert set(threading.enumerate()) <= before
    # After close, reads are synchronous and still right.
    np.testing.assert_array_equal(pre[2][0], direct[2][0])
    assert torch.equal(cams.get(3).image, torch.as_tensor(direct[3][0]))
    assert set(threading.enumerate()) <= before


def test_realsense_and_unknown_types_raise_like_jax():
    cfg = load_config("configs/synthetic/smoke.yaml")
    cfg["Dataset"]["type"] = "realsense"
    with pytest.raises(ImportError) as got:
        datasets.load_dataset(cfg)
    with pytest.raises(ImportError) as ref:
        jdatasets.load_dataset(cfg)
    assert str(got.value) == str(ref.value)
    cfg["Dataset"]["type"] = "nope"
    with pytest.raises(ValueError, match="Unknown dataset type"):
        datasets.load_dataset(cfg)


def _rodrigues(v):
    """Rotation matrix of an axis-angle vector."""
    theta = np.linalg.norm(v)
    k = np.asarray(v) / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


@pytest.mark.parametrize("size", [(1200, 680), (64, 48)])
def test_undistortion_matches_opencv(size):
    """The undistortion map equals cv2.initUndistortRectifyMap bit for bit
    for R = I with K_new = K. With a rectifying R and another K_new, at
    most 4 of the 2 x w x h values differ, each by one float32 ulp
    (OpenCV's vector code fuses multiply-adds; 1 value of 1.6 M at
    1200x680, 4.7e-10 px). `Remap` equals cv2.remap(INTER_LINEAR) on a
    random float32 image bit for bit, inside the frame and on the pixels
    whose taps leave it (zero border)."""
    import cv2
    import torch

    w, h = size
    k = np.array([[0.5 * w, 0, w / 2 - 0.5], [0, 0.5 * w, h / 2 - 0.5], [0, 0, 1.0]])
    dist = np.array([0.05, -0.01, 0.001, -0.0015, 0.003])
    r = _rodrigues([0.01, -0.02, 0.005])
    k_new = np.array([[0.48 * w, 0, w / 2 + 3], [0, 0.49 * w, h / 2 - 2], [0, 0, 1.0]])
    img = np.random.default_rng(0).uniform(0, 1, (h, w, 3)).astype(np.float32)
    for rot, kn in ((np.eye(3), k), (r, k_new)):
        mx, my = datasets.undistort_rectify_map(k, dist, rot, kn, (w, h))
        rx, ry = cv2.initUndistortRectifyMap(k, dist, rot, kn, (w, h), cv2.CV_32FC1)
        if kn is k:
            np.testing.assert_array_equal(mx, rx)
            np.testing.assert_array_equal(my, ry)
        else:
            for a, b in ((mx, rx), (my, ry)):
                off = a != b
                assert off.sum() <= 4
                np.testing.assert_array_equal(np.abs(a.view(np.int32) - b.view(np.int32))[off], 1)
        got = datasets.Remap(rx, ry, (h, w))(torch.from_numpy(img.transpose(2, 0, 1).copy()))
        ref = cv2.remap(img, rx, ry, cv2.INTER_LINEAR).transpose(2, 0, 1)
        border = ~((rx >= 0) & (rx < w - 1) & (ry >= 0) & (ry < h - 1))
        assert border.sum() > 0
        np.testing.assert_array_equal(got.numpy(), ref)


def test_euroc_rectification_matches_jax(trees):
    """EuRoC with cam0 / cam1 rectification: the port's maps feed the same
    uint8 remap and SGBM as the JAX loader's cv2 maps; the depth and the
    colour are equal exactly."""
    import copy

    cfg = copy.deepcopy(trees["euroc"])
    c = cfg["Dataset"]["Calibration"]
    raw = dict(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], k1=0.04, k2=-0.01, p1=0.001,
               p2=-0.0005, k3=0.002)
    opt = dict(fx=c["fx"] * 0.97, fy=c["fy"] * 0.97, cx=c["cx"] + 1.5, cy=c["cy"] - 0.5)
    c.update(distorted=True,
             cam0=dict(raw=raw, opt=opt, R=dict(data=_rodrigues([0.004, -0.01, 0.002]).ravel()
                                                 .tolist())),
             cam1=dict(raw=raw, opt=opt, R=dict(data=_rodrigues([-0.003, 0.008, -0.001]).ravel()
                                                 .tolist())))
    got, ref = datasets.load_dataset(cfg), jdatasets.load_dataset(cfg)
    for i in range(N_FRAMES):
        for g, r in zip(got[i], ref[i]):
            if r is not None:
                np.testing.assert_array_equal(g, r)

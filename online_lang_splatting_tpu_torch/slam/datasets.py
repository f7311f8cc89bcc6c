"""RGB-D datasets (port of slam/datasets.py), numpy only.

The parsers match the JAX package's: `ReplicaV2Dataset` (vMAP layout
rgb/rgb_*.png, depth/depth_*.png, traj_w_c.txt used verbatim as W2C),
`ReplicaDataset` (results/frame*.jpg, traj.txt C2W, inverted),
`TUMDataset` (timestamp association, 32 FPS subsampling), `EuRoCDataset`
(rectified stereo pair, SGBM depth), `RealsenseDataset` (live capture),
and the analytic `SyntheticDataset`, which needs no data on disk. Frames
decode through the port's own decoder (`native.decoder()`, chosen once per
process). Lens undistortion and stereo rectification maps are built here
(`undistort_rectify_map`, equal to OpenCV's) and applied by `Remap`;
pyrealsense2 is imported only for live capture, and cv2 only by EuRoC's
`__getitem__`, for the uint8 remap and SGBM of the stereo pair.
"""

from __future__ import annotations

import glob
import re
from pathlib import Path

import numpy as np
import torch

from .. import native
from ..ops import graphics


def _natsorted(paths):
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    return sorted(paths, key=key)


def undistort_rectify_map(k, dist, r, k_new, size):
    """(map_x, map_y) float32 (H, W): for each pixel of the rectified image
    the source position, through K_new^-1, R^-1 and the Brown-Conrady model
    (k1, k2, p1, p2, k3) of camera K, in float64 rounded once to float32
    as `cv2.initUndistortRectifyMap(k, dist, r, k_new, size, CV_32FC1)`
    computes it: bit-equal for R = I, K_new = K; with a rectifying R an
    odd value differs by one float32 ulp, where OpenCV's vector code fuses
    a multiply-add (tests/test_torch_datasets.py)."""
    w, h = size
    ir = np.linalg.inv(np.asarray(k_new, np.float64) @ np.asarray(r, np.float64))
    k1, k2, p1, p2, k3 = (float(c) for c in dist)
    j = np.arange(w, dtype=np.float64)[None]
    i = np.arange(h, dtype=np.float64)[:, None]
    xw = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    yw = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    ww = i * ir[2, 1] + ir[2, 2] + j * ir[2, 0]
    inv = 1.0 / ww
    x, y = xw * inv, yw * inv
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = k[0][0] * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + k[0][2]
    v = k[1][1] * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + k[1][2]
    return u.astype(np.float32), v.astype(np.float32)


class Remap:
    """Bilinear sampling of (C, H, W) float images at a float map's
    positions, zero outside the source: `cv2.remap(INTER_LINEAR,
    BORDER_CONSTANT)` on float32, bit for bit (two x lerps and one y lerp,
    each a fused multiply-add, emulated in float64 and rounded once).

    The four taps' flat indices and the fractions are computed once; they
    are moved to a tensor's device at its first use there."""

    def __init__(self, map_x: np.ndarray, map_y: np.ndarray, src_hw):
        h, w = src_hw
        x0, y0 = np.floor(map_x).astype(np.int64), np.floor(map_y).astype(np.int64)
        taps, valid = [], []
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                taps.append(np.where(ok, yy * w + xx, 0).reshape(-1))
                valid.append(ok.reshape(-1))
        self.shape = map_x.shape
        self._host = {
            "taps": torch.as_tensor(np.stack(taps)),
            "valid": torch.as_tensor(np.stack(valid)),
            "ax": torch.as_tensor((map_x - x0).astype(np.float32).reshape(-1)),
            "ay": torch.as_tensor((map_y - y0).astype(np.float32).reshape(-1)),
        }
        self._on = {torch.device("cpu"): self._host}

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """(C, H, W) float32 -> (C, *map shape) float32 on img's device."""
        dev = img.device
        if dev not in self._on:
            self._on[dev] = {k: v.to(dev) for k, v in self._host.items()}
        t = self._on[dev]
        flat = img.reshape(img.shape[0], -1)
        v = [torch.where(ok, flat[:, idx], 0.0) for idx, ok in zip(t["taps"], t["valid"])]
        top = _fma(t["ax"], v[1] - v[0], v[0])
        bottom = _fma(t["ax"], v[3] - v[2], v[2])
        return _fma(t["ay"], bottom - top, top).reshape(img.shape[0], *self.shape)


def _fma(a, b, c):
    """a * b + c for float32 tensors, rounded once (float64 holds the
    product exactly)."""
    return (a.double() * b.double() + c.double()).float()


class BaseDataset:
    """Common RGB-D access: returns (image (3,H,W) [0,1], depth (H,W) m,
    pose (4,4) W2C, gt_lang_feat, lang_feat_mask)."""

    def __init__(self, config: dict):
        self.config = config
        calib = config["Dataset"]["Calibration"]
        self.width = calib["width"]
        self.height = calib["height"]
        self.fx, self.fy = calib["fx"], calib["fy"]
        self.cx, self.cy = calib["cx"], calib["cy"]
        self.depth_scale = calib.get("depth_scale", 1.0)
        self.fovx = graphics.focal_to_fov(self.fx, self.width)
        self.fovy = graphics.focal_to_fov(self.fy, self.height)
        self.distorted = calib.get("distorted", False)
        self.dist_coeffs = np.array(
            [calib.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3")])
        self.undistort = None
        if self.distorted:
            # Built once; every frame is remapped through it.
            k = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]])
            self.undistort = Remap(*undistort_rectify_map(
                k, self.dist_coeffs, np.eye(3), k, (self.width, self.height)),
                (self.height, self.width))
        self.color_paths: list[str] = []
        self.depth_paths: list[str] = []
        self.poses: list[np.ndarray] = []
        self.load_labels = bool(config.get("language", {}).get("labels_from_file", False))
        self.feat_map_paths: list[str] = []
        if self.load_labels:
            label_path = config["language"]["lang_label_path"]
            self.feat_map_paths = sorted(glob.glob(f"{label_path}/*_ld.npy"))

    def __len__(self):
        return len(self.color_paths)

    def __getitem__(self, idx):
        dec = native.decoder()
        color = dec.rgb(self.color_paths[idx], self.height, self.width)
        if self.undistort is not None:
            color = self.undistort(torch.from_numpy(color)).numpy()
        depth = dec.depth(self.depth_paths[idx], self.height, self.width,
                          float(self.depth_scale))
        gt_lang = lang_mask = None
        if self.load_labels and idx < len(self.feat_map_paths):
            gt_lang = np.load(self.feat_map_paths[idx])
            lang_mask = gt_lang
        color = np.clip(color, 0.0, 1.0)
        return color, depth, self.poses[idx].astype(np.float32), gt_lang, lang_mask


class ReplicaV2Dataset(BaseDataset):
    """vMAP-layout Replica (rgb/rgb_*.png, depth/depth_*.png, traj_w_c.txt);
    the poses are W2C as written, as the reference parser reads them."""

    def __init__(self, config: dict):
        super().__init__(config)
        root = config["Dataset"]["dataset_path"]
        self.color_paths = _natsorted(glob.glob(f"{root}/rgb/rgb_*.png"))
        self.depth_paths = _natsorted(glob.glob(f"{root}/depth/depth_*.png"))
        with open(f"{root}/traj_w_c.txt") as f:
            lines = f.readlines()
        self.poses = [np.array(list(map(float, lines[i].split()))).reshape(4, 4)
                      for i in range(len(self.color_paths))]


class ReplicaDataset(BaseDataset):
    """Original MonoGS Replica layout (results/frame*.jpg, traj.txt C2W)."""

    def __init__(self, config: dict):
        super().__init__(config)
        root = config["Dataset"]["dataset_path"]
        self.color_paths = _natsorted(glob.glob(f"{root}/results/frame*.jpg"))
        self.depth_paths = _natsorted(glob.glob(f"{root}/results/depth*.png"))
        with open(f"{root}/traj.txt") as f:
            lines = f.readlines()
        self.poses = [np.linalg.inv(np.array(list(map(float, ln.split()))).reshape(4, 4))
                      for ln in lines[: len(self.color_paths)]]


class TUMDataset(BaseDataset):
    """TUM RGB-D: rgb / depth / ground truth associated by timestamp, then
    subsampled to at most `frame_rate` frames per second."""

    def __init__(self, config: dict, frame_rate: float = 32.0):
        super().__init__(config)
        root = Path(config["Dataset"]["dataset_path"])
        rgb = self._read_list(root / "rgb.txt")
        depth = self._read_list(root / "depth.txt")
        gt_file = root / "groundtruth.txt"
        if not gt_file.exists():
            gt_file = root / "pose.txt"
        gt = self._read_list(gt_file)
        assoc = self._associate(rgb[:, 0], depth[:, 0], gt[:, 0])
        # Keep a frame only when more than 1/frame_rate s has passed since
        # the last kept one.
        t_rgb = rgb[:, 0].astype(np.float64)
        indices = [0]
        for a in range(1, len(assoc)):
            if t_rgb[assoc[a][0]] - t_rgb[assoc[indices[-1]][0]] > 1.0 / frame_rate:
                indices.append(a)
        for a in indices:
            i, j, k = assoc[a]
            self.color_paths.append(str(root / rgb[i, 1]))
            self.depth_paths.append(str(root / depth[j, 1]))
            q = gt[k, 4:8].astype(np.float64)  # qx qy qz qw
            c2w = np.eye(4)
            c2w[:3, :3] = _quat_to_rot(q)
            c2w[:3, 3] = gt[k, 1:4].astype(np.float64)
            self.poses.append(np.linalg.inv(c2w))

    @staticmethod
    def _read_list(path):
        rows = []
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                rows.append(line.split())
        return np.array(rows, dtype=object)

    @staticmethod
    def _associate(t_rgb, t_depth, t_gt, max_dt=0.08):
        t_rgb = t_rgb.astype(np.float64)
        t_depth = t_depth.astype(np.float64)
        t_gt = t_gt.astype(np.float64)
        out = []
        for i, t in enumerate(t_rgb):
            j = int(np.argmin(np.abs(t_depth - t)))
            k = int(np.argmin(np.abs(t_gt - t)))
            if abs(t_depth[j] - t) < max_dt and abs(t_gt[k] - t) < max_dt:
                out.append((i, j, k))
        return out


def _quat_to_rot(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class SyntheticDataset(BaseDataset):
    """Analytic textured wall + floor scene seen from a smooth camera orbit
    (same texture, trajectory and ray casting as the JAX package)."""

    def __init__(self, config: dict):
        super().__init__(config)
        self.n = config["Dataset"].get("num_frames", 30)
        self.color_paths = ["<synthetic>"] * self.n
        self.rng = np.random.default_rng(config["Dataset"].get("seed", 0))
        self.tex = self.rng.uniform(0.1, 0.9, size=(8, 8, 3)).astype(np.float32)
        self._traj_n = int(config["Dataset"].get("trajectory_frames", self.n))
        self.poses = [self._pose(i) for i in range(self.n)]
        # Open-vocabulary ground truth: 2 classes (wall / floor) or 9 (the
        # wall in 5 world-x bands, the floor in 4 world-z bands).
        n_sem = int(config["Dataset"].get("semantic_classes", 2))
        if n_sem not in (2, 9):
            raise ValueError(f"semantic_classes must be 2 or 9, not {n_sem}")
        self.SEMANTIC_LABELS = (
            ("wall", "floor") if n_sem == 2 else
            ("window", "door", "poster", "shelf", "painting",
             "rug", "mat", "wooden floor", "tile floor"))
        self._n_sem = n_sem

    def _pose(self, i):
        t = i / max(self._traj_n - 1, 1)
        yaw = 0.5 * t
        c, s = np.cos(yaw), np.sin(yaw)
        w2c = np.eye(4, dtype=np.float64)
        w2c[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        w2c[:3, 3] = [-0.15 * t, -0.05 * np.cos(2 * np.pi * t), 0.1 * t]
        return w2c

    def _raycast(self, idx):
        w2c = self.poses[idx]
        c2w = np.linalg.inv(w2c)
        h, w = self.height, self.width
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        dirs = np.stack(
            [(xs - self.cx) / self.fx, (ys - self.cy) / self.fy,
             np.ones_like(xs)], -1)
        dirs_w = dirs @ c2w[:3, :3].T
        org = c2w[:3, 3]
        # Wall z = 4 plus a floor y = 1.5.
        tz = (4.0 - org[2]) / np.maximum(dirs_w[..., 2], 1e-6)
        ty = (1.5 - org[1]) / np.where(np.abs(dirs_w[..., 1]) > 1e-6,
                                       dirs_w[..., 1], 1e6)
        ty = np.where(ty > 0, ty, 1e6)
        tt = np.minimum(tz, ty)
        return w2c, org, dirs, dirs_w, tz, tt

    # World-coordinate band edges of the 9-class partition: the wall by x,
    # the floor by z.
    _WALL_X_EDGES = (-1.5, 0.5, 2.5, 5.0)
    _FLOOR_Z_EDGES = (2.2, 2.9, 3.5)

    def gt_semantics(self, idx) -> np.ndarray:
        """(H, W) int class mask from the known geometry: with 2 classes 0 =
        wall (the z = 4 plane wins the ray intersection), 1 = floor; with 9
        the wall bands are classes 0-4 and the floor bands 5-8."""
        _, org, _, dirs_w, tz, tt = self._raycast(idx)
        on_wall = tt == tz
        if self._n_sem == 2:
            return np.where(on_wall, 0, 1).astype(np.int32)
        pts = org + tt[..., None] * dirs_w
        wall_band = np.digitize(pts[..., 0], self._WALL_X_EDGES)
        floor_band = np.digitize(pts[..., 2], self._FLOOR_Z_EDGES)
        return np.where(on_wall, wall_band, 5 + floor_band).astype(np.int32)

    def __getitem__(self, idx):
        w2c, org, dirs, dirs_w, _, tt = self._raycast(idx)
        pts = org + tt[..., None] * dirs_w
        u = np.abs(pts[..., 0] % 4.0) / 4.0
        v = np.abs((pts[..., 1] + pts[..., 2]) % 4.0) / 4.0
        ui = (u * 7.99).astype(np.int32)
        vi = (v * 7.99).astype(np.int32)
        color = self.tex[vi, ui]
        depth = (tt * dirs[..., 2]).astype(np.float32)
        # Missed rays and grazing hits past 20 m read as invalid (depth 0,
        # black), like a depth sensor.
        missed = (tt >= 1e5) | (depth > 20.0)
        depth[missed] = 0.0
        color[missed] = 0.0
        color = np.transpose(np.clip(color, 0, 1), (2, 0, 1)).astype(np.float32)
        return color, depth, w2c.astype(np.float32), None, None


class EuRoCDataset(BaseDataset):
    """EuRoC MAV stereo: SGBM depth from the rectified cam0 / cam1 pair.

    With `distorted` set and cam0 / cam1 calibration present (the
    reference configs' layout: cam{0,1}: {raw: {fx..k3}, opt: {fx..cy},
    R: {data: 9}}), both images are remapped through rectification maps
    (`undistort_rectify_map`) before SGBM. The uint8 remap and SGBM stay
    OpenCV's: they are the one place the port imports cv2."""

    def __init__(self, config: dict):
        super().__init__(config)
        root = Path(config["Dataset"]["dataset_path"])
        start = config["Dataset"].get("start_idx", 0)
        calib = config["Dataset"]["Calibration"]
        self._rect_maps = None
        if calib.get("distorted", False) and "cam0" in calib:
            def cam_maps(cam):
                raw, opt = cam["raw"], cam["opt"]
                k_raw = np.array([[raw["fx"], 0.0, raw["cx"]], [0.0, raw["fy"], raw["cy"]],
                                  [0.0, 0.0, 1.0]])
                dist = np.array([raw.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3")])
                rmat = np.array(cam["R"]["data"]).reshape(3, 3)
                k_new = np.array([[opt["fx"], 0.0, opt["cx"]], [0.0, opt["fy"], opt["cy"]],
                                  [0.0, 0.0, 1.0]])
                return undistort_rectify_map(k_raw, dist, rmat, k_new,
                                             (self.width, self.height))

            self._rect_maps = (cam_maps(calib["cam0"]), cam_maps(calib["cam1"]))
        self.color_paths = _natsorted(
            [str(p) for p in (root / "mav0/cam0/data").glob("*.png")])[start:]
        self.color_paths_r = _natsorted(
            [str(p) for p in (root / "mav0/cam1/data").glob("*.png")])[start:]
        # Ground truth from the state-estimate CSV, matched by timestamp.
        rows = np.genfromtxt(root / "mav0/state_groundtruth_estimate0/data.csv",
                             delimiter=",", skip_header=1)
        t_gt = rows[:, 0]
        stamps = np.array([float(Path(p).stem) for p in self.color_paths])
        self.poses = []
        keep = []
        for i, t in enumerate(stamps):
            j = int(np.argmin(np.abs(t_gt - t)))
            if abs(t_gt[j] - t) > 0.05e9:
                continue
            q = rows[j, 4:8]  # qw qx qy qz
            c2w = np.eye(4)
            c2w[:3, :3] = _quat_to_rot([q[1], q[2], q[3], q[0]])
            c2w[:3, 3] = rows[j, 1:4]
            self.poses.append(np.linalg.inv(c2w))
            keep.append(i)
        self.color_paths = [self.color_paths[i] for i in keep]
        self.color_paths_r = [self.color_paths_r[i] for i in keep]

    def __getitem__(self, idx):
        # SGBM has no PyTorch counterpart: the port's only use of OpenCV.
        import cv2

        left = cv2.imread(self.color_paths[idx], cv2.IMREAD_GRAYSCALE)
        right = cv2.imread(self.color_paths_r[idx], cv2.IMREAD_GRAYSCALE)
        if self._rect_maps is not None:
            (m0x, m0y), (m1x, m1y) = self._rect_maps
            left = cv2.remap(left, m0x, m0y, cv2.INTER_LINEAR)
            right = cv2.remap(right, m1x, m1y, cv2.INTER_LINEAR)
        # The reference StereoDataset's SGBM settings.
        sgbm = cv2.StereoSGBM_create(minDisparity=0, numDisparities=64, blockSize=20)
        sgbm.setUniquenessRatio(40)
        disp = sgbm.compute(left, right).astype(np.float32) / 16.0
        disp[disp == 0] = 1e10
        # ORB-SLAM2's EuRoC baseline * fx.
        baseline_fx = self.config["Dataset"].get("baseline_fx", 47.90639384423901)
        depth = baseline_fx / disp
        depth[depth < 0] = 0.0
        color = np.repeat(left[None].astype(np.float32) / 255.0, 3, axis=0)
        return (np.clip(color, 0, 1), depth.astype(np.float32),
                self.poses[idx].astype(np.float32), None, None)


class RealsenseDataset(BaseDataset):
    """Live RealSense RGB-D capture (needs pyrealsense2); frames stream with
    identity poses, which SLAM estimates."""

    def __init__(self, config: dict):
        super().__init__(config)
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise ImportError(
                "RealsenseDataset requires pyrealsense2 (live capture only)") from e
        self.rs = rs
        self.pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.depth, 640, 480, rs.format.z16, 30)
        cfg.enable_stream(rs.stream.color, 640, 480, rs.format.rgb8, 30)
        self.profile = self.pipeline.start(cfg)
        self.align = rs.align(rs.stream.color)
        self.n = config["Dataset"].get("num_frames", 10_000)
        self.color_paths = ["<live>"] * self.n
        self.poses = [np.eye(4, dtype=np.float32)] * self.n

    def __getitem__(self, idx):
        frames = self.align.process(self.pipeline.wait_for_frames())
        color = np.asanyarray(frames.get_color_frame().get_data())
        depth = np.asanyarray(frames.get_depth_frame().get_data())
        color = np.transpose(color.astype(np.float32) / 255.0, (2, 0, 1))
        if self.undistort is not None:
            color = self.undistort(torch.from_numpy(np.ascontiguousarray(color))).numpy()
        depth = depth.astype(np.float32) / self.depth_scale
        return np.clip(color, 0, 1), depth, np.eye(4, dtype=np.float32), None, None


_TYPES = {"replicav2": ReplicaV2Dataset, "replica": ReplicaDataset, "tum": TUMDataset,
          "euroc": EuRoCDataset, "realsense": RealsenseDataset,
          "synthetic": SyntheticDataset}


def load_dataset(config: dict) -> BaseDataset:
    kind = config["Dataset"]["type"]
    if kind not in _TYPES:
        raise ValueError(f"Unknown dataset type: {kind}")
    return _TYPES[kind](config)

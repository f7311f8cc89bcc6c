"""RGB-D datasets (port of slam/datasets.py), numpy only.

Only the analytic `SyntheticDataset` is ported so far: it feeds the
replica-scale main path and needs no data on disk. The disk-backed types
of the JAX package (replica, replicav2, tum, euroc, realsense) come with a
later slice of the port.
"""

from __future__ import annotations

import numpy as np

from ..ops import graphics


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
        self.color_paths: list[str] = []
        self.poses: list[np.ndarray] = []

    def __len__(self):
        return len(self.color_paths)


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

    def _pose(self, i):
        t = i / max(self._traj_n - 1, 1)
        yaw = 0.5 * t
        c, s = np.cos(yaw), np.sin(yaw)
        w2c = np.eye(4, dtype=np.float64)
        w2c[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        w2c[:3, 3] = [-0.15 * t, -0.05 * np.cos(2 * np.pi * t), 0.1 * t]
        return w2c

    def __getitem__(self, idx):
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


def load_dataset(config: dict) -> BaseDataset:
    kind = config["Dataset"]["type"]
    if kind == "synthetic":
        return SyntheticDataset(config)
    if kind in ("replicav2", "replica", "tum", "euroc", "realsense"):
        raise NotImplementedError(
            f"dataset type {kind!r} is not ported yet; it comes with the "
            "PyTorch port's dataset slice (ROADMAP queue A, item 8)")
    raise ValueError(f"Unknown dataset type: {kind}")

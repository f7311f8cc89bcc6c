"""Per-frame camera state and the tracking gradient mask (port of
slam/camera.py). Poses are host numpy; images and depths are tensors on
the run's device."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops import graphics, losses
from .losses import median


def _grad_mask_device(image: torch.Tensor, is_replica: bool, rows: int,
                      cols: int, edge_threshold: float) -> torch.Tensor:
    """Scharr edge mask (1, H, W): "replica" datasets threshold per block
    against the block median, every other type against the global median."""
    gray = torch.mean(image, dim=0, keepdim=True)
    grad_v, grad_h = losses.image_gradient(gray)
    mask_v, mask_h = losses.image_gradient_mask(gray)
    intensity = torch.sqrt(torch.square(grad_v * mask_v)
                           + torch.square(grad_h * mask_h))
    if not is_replica:
        med = median(intensity)
        return (intensity > med * edge_threshold).to(torch.float32)
    h, w = intensity.shape[1], intensity.shape[2]
    bh, bw = h // rows, w // cols
    blocks = intensity[0, : rows * bh, : cols * bw].reshape(rows, bh, cols, bw)
    flat = blocks.permute(0, 2, 1, 3).reshape(rows, cols, bh * bw)
    srt = torch.sort(flat, dim=-1).values
    n = bh * bw
    med = 0.5 * (srt[..., (n - 1) // 2] + srt[..., n // 2])
    out = (blocks > med[:, None, :, None] * edge_threshold).to(torch.float32)
    full = torch.zeros((h, w), dtype=torch.float32, device=image.device)
    full[: rows * bh, : cols * bw] = out.reshape(rows * bh, cols * bw)
    return full[None]


@dataclasses.dataclass
class Camera:
    uid: int
    image: Any            # (3, H, W) float32 tensor in [0, 1]
    depth: np.ndarray     # (H, W) float32 metres (host)
    r_gt: np.ndarray
    t_gt: np.ndarray
    fx: float
    fy: float
    cx: float
    cy: float
    fovx: float
    fovy: float
    height: int
    width: int
    r: np.ndarray = None
    t: np.ndarray = None
    exposure_a: float = 0.0
    exposure_b: float = 0.0
    grad_mask: Any = None
    gt_lang_feat: Any = None     # (L, 192, 192) supervision map (tensor)
    coco_lang_feat: Any = None   # (N, 32) two-stage codes (tensor)
    image_host: Any = None       # (3, H, W) host copy (numpy)
    depth_dev: Any = None        # (1, H, W) tensor copy of `depth`

    def __post_init__(self):
        if self.r is None:
            self.r = np.eye(3, dtype=np.float32)
        if self.t is None:
            self.t = np.zeros(3, dtype=np.float32)

    @classmethod
    def from_dataset(cls, dataset, idx: int, device) -> "Camera":
        color, depth, pose, gt_lang, _ = dataset[idx]
        cam = cls(
            uid=idx,
            image=torch.as_tensor(color, device=device),
            depth=depth,
            r_gt=pose[:3, :3].astype(np.float32),
            t_gt=pose[:3, 3].astype(np.float32),
            fx=dataset.fx, fy=dataset.fy, cx=dataset.cx, cy=dataset.cy,
            fovx=dataset.fovx, fovy=dataset.fovy,
            height=dataset.height, width=dataset.width,
            gt_lang_feat=None if gt_lang is None else torch.as_tensor(
                gt_lang, device=device),
        )
        cam.image_host = color
        return cam

    def update_rt(self, r, t):
        self.r = np.asarray(r, np.float32)
        self.t = np.asarray(t, np.float32)

    @property
    def world_view_transform(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.r
        m[:3, 3] = self.t
        return m

    def compute_grad_mask(self, config: dict):
        self.grad_mask = _grad_mask_device(
            self.image, config["Dataset"]["type"] == "replica", 32, 32,
            float(config["Training"]["edge_threshold"]),
        )
        if self.depth is not None:
            self.depth_dev = torch.as_tensor(self.depth, device=self.image.device)[None]

    def clean(self):
        self.image = None
        self.image_host = None
        self.depth = None
        self.depth_dev = None
        self.grad_mask = None
        self.gt_lang_feat = None
        self.coco_lang_feat = None


def camera_projection(cam: Camera, znear=0.01, zfar=100.0, device=None):
    return graphics.projection_matrix(
        znear, zfar, cam.cx, cam.cy, cam.fx, cam.fy, cam.width, cam.height,
        device=device)

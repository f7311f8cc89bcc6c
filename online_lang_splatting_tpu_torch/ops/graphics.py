"""Camera matrices (port of ops/graphics.py): the intrinsics "raw"
projection the rasterizer composes with the W2C pose, and focal <-> FoV."""

from __future__ import annotations

import math

import torch


def projection_matrix(znear, zfar, cx, cy, fx, fy, width, height,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """Intrinsics-based perspective projection (w = z_view)."""
    left = ((2 * cx - width) / width - 1.0) * width / 2.0
    right = ((2 * cx - width) / width + 1.0) * width / 2.0
    top = ((2 * cy - height) / height + 1.0) * height / 2.0
    bottom = ((2 * cy - height) / height - 1.0) * height / 2.0
    left = znear / fx * left
    right = znear / fx * right
    top = znear / fy * top
    bottom = znear / fy * bottom

    p = torch.zeros((4, 4), dtype=dtype, device=device)
    p[0, 0] = 2.0 * znear / (right - left)
    p[1, 1] = 2.0 * znear / (top - bottom)
    p[0, 2] = (right + left) / (right - left)
    p[1, 2] = (top + bottom) / (top - bottom)
    p[3, 2] = 1.0
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p


def focal_to_fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))

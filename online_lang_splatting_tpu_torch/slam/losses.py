"""Tracking and mapping photometric losses (port of slam/losses.py)."""

from __future__ import annotations

import torch

from ..ops.losses import abs_


def loss_tracking_rgbd(image, depth, opacity, gt_image, gt_depth, grad_mask,
                       exposure_a, exposure_b, *, alpha=0.95,
                       rgb_boundary_threshold=0.01):
    """Opacity-weighted masked RGB L1 (exposure-compensated) blended with
    masked depth L1. image (3,H,W), depth/opacity (1,H,W)."""
    image_ab = torch.exp(exposure_a) * image + exposure_b
    rgb_mask = (torch.sum(gt_image, dim=0) > rgb_boundary_threshold)[None]
    rgb_mask = rgb_mask * grad_mask
    l1_rgb = (opacity * abs_(image_ab * rgb_mask - gt_image * rgb_mask)).mean()
    depth_mask = (gt_depth > 0.01) & (opacity > 0.95)
    l1_depth = abs_(depth * depth_mask - gt_depth * depth_mask).mean()
    return alpha * l1_rgb + (1 - alpha) * l1_depth


def loss_mapping_rgbd(image, depth, gt_image, gt_depth, exposure_a,
                      exposure_b, *, alpha=0.95, rgb_boundary_threshold=0.01,
                      initialization=False):
    image_ab = image if initialization else (
        torch.exp(exposure_a) * image + exposure_b)
    rgb_mask = (torch.sum(gt_image, dim=0) > rgb_boundary_threshold)[None]
    depth_mask = gt_depth > 0.01
    l1_rgb = abs_(image_ab * rgb_mask - gt_image * rgb_mask).mean()
    l1_depth = abs_(depth * depth_mask - gt_depth * depth_mask).mean()
    return alpha * l1_rgb + (1 - alpha) * l1_depth


def isotropic_loss(scaling, active):
    """Masked mean |s - mean(s)| over active Gaussians (callers weight 10x)."""
    dev = abs_(scaling - scaling.mean(dim=1, keepdim=True))
    w = active.to(scaling.dtype)[:, None]
    return (dev * w).sum() / torch.clamp(w.sum() * scaling.shape[1], min=1.0)


def median(values: torch.Tensor) -> torch.Tensor:
    """Median that averages the two middle values of an even count, like
    numpy / jnp.median (torch.median returns the lower one). NaN if empty."""
    v = torch.sort(values.flatten()).values
    n = v.shape[0]
    if n == 0:
        return torch.tensor(float("nan"), dtype=values.dtype, device=values.device)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def median_depth(depth, opacity):
    """Median rendered depth where opacity > 0.95 and depth > 0."""
    valid = (depth > 0) & (opacity > 0.95)
    return median(depth[valid])

"""Volumetric TSDF fusion with multi-channel features (port of
tsdf/fusion.py).

One `integrate` handles any channel count (3 for colour, 15 for the
rendered language codes): every voxel centre is projected into the frame,
depth-tested with the classic truncated SDF update, and the feature
channels become running-weighted means. The JAX package updates every voxel
at once; here the voxels go through in chunks, so the temporaries (the
projected coordinates and the (C, chunk) feature gather) stay bounded while
the result is the same. Voxel centres are recomputed from the flat index
in each chunk with the JAX package's float32 formula, so the volume holds
no (N, 3) coordinate array. The state lives on the volume's device;
`get_point_cloud` and `get_volume` return numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 21  # voxels per integration step


class TSDFVolume:
    """Fixed-bounds voxel volume with C feature channels."""

    def __init__(self, vol_bnds, voxel_size: float, n_channels: int = 3, device="cuda",
                 chunk: int = CHUNK):
        vol_bnds = np.asarray(vol_bnds, np.float32)  # (3, 2)
        self.bounds = vol_bnds
        self.device = torch.device(device)
        self.voxel_size = float(voxel_size)
        self.trunc_margin = 5 * self.voxel_size
        self.dims = np.ceil((vol_bnds[:, 1] - vol_bnds[:, 0]) / voxel_size).astype(int)
        self.origin = vol_bnds[:, 0]
        self.n_voxels = int(np.prod(self.dims))
        self.n_channels = n_channels
        self.chunk = int(chunk)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._origin = torch.as_tensor(self.origin, **f32)
        self.tsdf = torch.ones(self.n_voxels, **f32)
        self.weights = torch.zeros(self.n_voxels, **f32)
        self.features = torch.zeros((n_channels, self.n_voxels), **f32)

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in (self.tsdf, self.weights, self.features))

    def world(self, flat_idx: torch.Tensor) -> torch.Tensor:
        """(n,) flat voxel indices -> (n, 3) float32 voxel centres, as the
        JAX package's `origin + (coords + 0.5) * voxel_size`."""
        dy, dz = int(self.dims[1]), int(self.dims[2])
        coords = torch.stack([flat_idx // (dy * dz), (flat_idx // dz) % dy, flat_idx % dz], -1)
        return self._origin + (coords.to(torch.float32) + 0.5) * self.voxel_size

    @torch.no_grad()
    def integrate(self, feat_im, depth_im, intrinsics, cam_pose_w2c, obs_weight: float = 1.0):
        """feat_im: (C, H, W) features (RGB or language codes); depth_im:
        (H, W) metres; cam_pose_w2c: (4, 4)."""
        f32 = dict(dtype=torch.float32, device=self.device)
        fx, fy, cx, cy = (float(np.float32(v)) for v in intrinsics)
        depth = torch.as_tensor(depth_im, **f32)
        feat = torch.as_tensor(feat_im, **f32)
        w2c = torch.as_tensor(cam_pose_w2c, **f32)
        h, w = depth.shape
        depth_flat = depth.reshape(-1)
        feat_flat = feat.reshape(feat.shape[0], -1)
        rot_t, trans = w2c[:3, :3].T, w2c[:3, 3]
        trunc = float(np.float32(self.trunc_margin))
        for a in range(0, self.n_voxels, self.chunk):
            b = min(a + self.chunk, self.n_voxels)
            cam = self.world(torch.arange(a, b, device=self.device)) @ rot_t + trans
            z = cam[:, 2]
            # Rounded (half to even, as jnp.round), then cast; the clamp
            # only keeps the cast defined where z is near 0 (never inside).
            u = torch.clamp(torch.round(cam[:, 0] / z * fx + cx), -2**30, 2**30).to(torch.int32)
            v = torch.clamp(torch.round(cam[:, 1] / z * fy + cy), -2**30, 2**30).to(torch.int32)
            inside = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            pix = (torch.clamp(v, 0, h - 1) * w + torch.clamp(u, 0, w - 1)).to(torch.int64)
            depth_val = depth_flat[pix]
            sdf = depth_val - z
            valid = inside & (depth_val > 0) & (sdf >= -trunc)
            dist = torch.clamp(sdf / trunc, max=1.0)
            w_old = self.weights[a:b]
            w_new = torch.where(valid, w_old + obs_weight, w_old)
            w_safe = torch.clamp(w_new, min=1e-8)
            self.tsdf[a:b] = torch.where(valid, (self.tsdf[a:b] * w_old + obs_weight * dist)
                                         / w_safe, self.tsdf[a:b])
            feat_val = feat_flat[:, pix]  # (C, n)
            old = self.features[:, a:b]
            self.features[:, a:b] = torch.where(
                valid[None], (old * w_old[None] + obs_weight * feat_val) / w_safe[None], old)
            self.weights[a:b] = w_new

    @torch.no_grad()
    def get_point_cloud(self, tsdf_thresh: float = 0.2, weight_thresh: float = 0.0):
        """Surface points: voxels near the zero crossing with observations.
        Returns numpy (points (M, 3), features (M, C))."""
        mask = (torch.abs(self.tsdf) < tsdf_thresh) & (self.weights > weight_thresh)
        idx = torch.nonzero(mask).reshape(-1)
        pts = self.world(idx).cpu().numpy()
        feats = self.features[:, idx].T.cpu().numpy()
        return pts, feats

    def get_volume(self):
        """numpy (tsdf (X, Y, Z), features (C, X, Y, Z))."""
        return (self.tsdf.cpu().numpy().reshape(self.dims),
                self.features.cpu().numpy().reshape((self.n_channels, *self.dims)))

    def get_weights(self) -> np.ndarray:
        return self.weights.cpu().numpy().reshape(self.dims)


def estimate_bounds(depth_frames, intrinsics, poses_w2c, margin: float = 0.1):
    """Frustum-union volume bounds (numpy, as in the JAX package)."""
    fx, fy, cx, cy = intrinsics
    mins = np.full(3, np.inf)
    maxs = np.full(3, -np.inf)
    for depth, w2c in zip(depth_frames, poses_w2c):
        h, w = depth.shape
        zmax = float(np.max(depth)) if np.any(depth > 0) else 1.0
        corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float32)
        c2w = np.linalg.inv(w2c)
        for z in (0.0, zmax):
            x = (corners[:, 0] - cx) / fx * z
            y = (corners[:, 1] - cy) / fy * z
            pts = np.stack([x, y, np.full(4, z)], -1) @ c2w[:3, :3].T + c2w[:3, 3]
            mins = np.minimum(mins, pts.min(axis=0))
            maxs = np.maximum(maxs, pts.max(axis=0))
    return np.stack([mins - margin, maxs + margin], axis=1)

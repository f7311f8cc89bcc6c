"""SLAM frontend: per-frame camera tracking + keyframe management (port of
slam/frontend.py).

`tracking_run` is the JAX package's single-dispatch while-loop written as
a Python loop with the same math: render → masked RGB-D loss →
pose/exposure Adam (0.9, 0.999, 1e-8) → SE(3) retraction, with the
‖tau‖ < 1e-4 exit, the optional loss-plateau exit or reduce-lr-on-plateau,
and keep-best. The loop renders drop the language channels and skip the
n_touched / n_contrib bookkeeping; a final render with stats gives the
median depth and the visibility mask. With a device mesh, `track` renders
each frame band-parallel (parallel/tile_shard.py).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import lie
from ..ops.raster import RasterSettings
from ..parallel.tile_shard import banded_render
from ..utils.profiling import span
from . import losses as L
from .camera import Camera
from .renderer import RenderInputs, render


def tracking_run(inputs: RenderInputs, view, proj, gt_image, gt_depth,
                 grad_mask, exposure_a, exposure_b, lrs, plateau_rtol=0.0,
                 lr_decay=1.0, *, settings: RasterSettings, max_iters: int,
                 alpha=0.95, rgb_threshold=0.01, plateau_patience: int = 5,
                 keep_best: bool = False, render_fn=render):
    """Track one frame from W2C `view` (4,4). Returns (view, exposure_a,
    exposure_b, n_iters, loss, median_depth, visibility (P,) bool).
    `render_fn` takes slam.renderer.render's arguments and gives its
    outputs (parallel.tile_shard.banded_render with a device mesh)."""
    dev = view.device
    f32 = dict(dtype=torch.float32, device=dev)
    track_inputs = inputs._replace(language=inputs.language[:, :0])
    loop_settings = settings._replace(stats=False)
    def upload(x):
        with span("sync.track.upload"):  # waits for the device
            return torch.as_tensor(x, **f32)

    ea = upload(exposure_a)
    eb = upload(exposure_b)
    lr_list = [upload(lrs[i]) for i in (0, 1, 2, 2)]
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = [torch.zeros(3, **f32), torch.zeros(3, **f32),
         torch.zeros((), **f32), torch.zeros((), **f32)]
    v = [x.clone() for x in m]
    t = torch.zeros((), **f32)
    lr_scale = torch.ones((), **f32)
    cnt = 0
    loss = torch.zeros((), **f32)
    best = (torch.full((), float("inf"), **f32), view, ea, eb)
    n_iters = 0
    converged = False
    while n_iters < max_iters and not converged:
        with span("track.iter"):
            rho = torch.zeros(3, **f32).requires_grad_(True)
            theta = torch.zeros(3, **f32).requires_grad_(True)
            ea_v = ea.clone().requires_grad_(True)
            eb_v = eb.clone().requires_grad_(True)
            out = render_fn(track_inputs, view, proj, loop_settings,
                            cam_trans_delta=rho, cam_rot_delta=theta)
            loss_t = L.loss_tracking_rgbd(
                out.color, out.depth, out.opacity, gt_image, gt_depth, grad_mask,
                ea_v, eb_v, alpha=alpha, rgb_boundary_threshold=rgb_threshold)
            grads = torch.autograd.grad(loss_t, [rho, theta, ea_v, eb_v])
            with torch.no_grad():
                loss = loss_t.detach()
                improved = loss < best[0] * (1 - plateau_rtol)
                better = loss < best[0]
                best = tuple(torch.where(better, new, old) for new, old in
                             zip((loss, view, ea, eb), best))
                t = t + 1
                steps = []
                for i, (g, lr) in enumerate(zip(grads, lr_list)):
                    m[i] = b1 * m[i] + (1 - b1) * g
                    v[i] = b2 * v[i] + (1 - b2) * g * g
                    steps.append(-lr * lr_scale * (m[i] / (1 - b1 ** t))
                                 / (torch.sqrt(v[i] / (1 - b2 ** t)) + eps))
                trans_d, rot_d, d_ea, d_eb = steps
                tau = torch.cat([trans_d, rot_d])
                view = lie.se3_exp(tau) @ view
                ea = ea + d_ea
                eb = eb + d_eb
                host = torch.stack([torch.linalg.norm(tau), improved.to(torch.float32)])
                with span("sync.track.converge"):
                    tau_norm, improved_h = host.tolist()
        n_iters += 1
        cnt = 0 if improved_h > 0.5 else cnt + 1
        trigger = plateau_rtol > 0 and cnt >= plateau_patience
        if trigger and lr_decay < 1:
            lr_scale = lr_scale * lr_decay
            cnt = 0
        converged = tau_norm < 1e-4 or (trigger and lr_decay >= 1)
    if keep_best:
        loss, view, ea, eb = best
    with torch.no_grad():
        out = render_fn(track_inputs, view, proj, settings)
        med = L.median_depth(out.depth, out.opacity)
    return view, ea, eb, n_iters, loss, med, out.n_touched > 0


def cv_extrapolate(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Constant-velocity prediction from W2C at t-1 (`v1`) and t-2 (`v2`)."""
    return v1 @ np.linalg.inv(v2) @ v1


class FrontEnd:
    def __init__(self, config: dict, settings: RasterSettings, device,
                 mesh=None):
        self.config = config
        self.settings = settings
        self.device = torch.device(device)
        # Tracking renders band-parallel over a device mesh
        # (parallel/tile_shard.py).
        self.mesh = mesh
        tr = config["Training"]
        self.tracking_itr_num = tr["tracking_itr_num"]
        self.motion_model = tr.get("motion_model", "static")
        self.plateau_rtol = float(tr.get("tracking_plateau_rtol", 0.0))
        self.plateau_patience = int(tr.get("tracking_plateau_patience", 5))
        self.lr_decay = float(tr.get("tracking_lr_decay", 1.0))
        self.keep_best = bool(tr.get("tracking_best_pose", False))
        self.kf_interval = tr["kf_interval"]
        self.window_size = tr["window_size"]
        self.use_gt_pose = tr.get("use_gt_pose", False)
        self.kf_translation = tr["kf_translation"]
        self.kf_min_translation = tr["kf_min_translation"]
        self.kf_overlap = tr["kf_overlap"]
        self.kf_cutoff = tr.get("kf_cutoff", 0.4)
        self.rgb_boundary_threshold = tr["rgb_boundary_threshold"]
        self.lr_trans = tr["lr"]["cam_trans_delta"]
        self.lr_rot = tr["lr"]["cam_rot_delta"]
        self.cameras: Dict[int, Camera] = {}
        self.occ_aware_visibility: Dict[int, np.ndarray] = {}
        self.current_window: List[int] = []
        self.kf_indices: List[int] = []
        self.median_depth = 1.0
        self.render_inputs: Optional[RenderInputs] = None
        self.track_iters: List[int] = []
        self.track_losses: List[float] = []

    def track(self, cam: Camera, prev: Camera, proj,
              prev2: Optional[Camera] = None) -> np.ndarray:
        """Track `cam` from `prev`'s pose (or the constant-velocity
        extrapolation with `motion_model: cv`). Returns visibility."""
        if self.motion_model == "cv" and prev2 is not None:
            init = cv_extrapolate(prev.world_view_transform,
                                  prev2.world_view_transform)
            cam.update_rt(init[:3, :3], init[:3, 3])
        else:
            cam.update_rt(prev.r, prev.t)
        if self.use_gt_pose:
            cam.update_rt(cam.r_gt, cam.t_gt)
        with span("sync.track.upload"):
            view0 = torch.as_tensor(cam.world_view_transform, device=self.device)
        lrs = (self.lr_trans, self.lr_rot, 0.01)
        max_iters = 1 if self.use_gt_pose else self.tracking_itr_num
        render_fn = render if self.mesh is None else partial(banded_render, self.mesh)
        view, ea, eb, n_iters, loss, med, visibility = tracking_run(
            self.render_inputs, view0, proj, cam.image, cam.depth_dev,
            cam.grad_mask, cam.exposure_a, cam.exposure_b, lrs,
            self.plateau_rtol, self.lr_decay, settings=self.settings,
            max_iters=max_iters, rgb_threshold=self.rgb_boundary_threshold,
            plateau_patience=self.plateau_patience, keep_best=self.keep_best,
            render_fn=render_fn)
        if not self.use_gt_pose:
            with span("sync.track.view"):
                v = view.cpu().numpy()
            if np.isfinite(v).all():
                cam.update_rt(v[:3, :3], v[:3, 3])
                with span("sync.track.exposure"):
                    cam.exposure_a = float(ea)
                with span("sync.track.exposure"):
                    cam.exposure_b = float(eb)
            else:
                # Never commit a diverged pose: keep the motion-model init
                # and reset exposure.
                print(f"[frontend] WARNING: non-finite tracked pose at "
                      f"frame {cam.uid}; keeping motion-model init")
                cam.exposure_a = 0.0
                cam.exposure_b = 0.0
        self.track_iters.append(int(n_iters))
        with span("sync.track.loss"):
            self.track_losses.append(float(loss))
        with span("sync.track.depth"):
            self.median_depth = float(med)
        if not np.isfinite(self.median_depth):
            self.median_depth = 1.0
        with span("sync.track.visibility"):
            return visibility.cpu().numpy()

    def is_keyframe(self, cur_idx: int, last_kf_idx: int,
                    visibility: np.ndarray) -> bool:
        cur, last = self.cameras[cur_idx], self.cameras[last_kf_idx]
        pose_cw = cur.world_view_transform
        last_wc = np.linalg.inv(last.world_view_transform)
        dist = np.linalg.norm((pose_cw @ last_wc)[:3, 3])
        dist_check = dist > self.kf_translation * self.median_depth
        dist_check2 = dist > self.kf_min_translation * self.median_depth
        last_vis = self.occ_aware_visibility[last_kf_idx]
        union = np.count_nonzero(visibility | last_vis)
        intersection = np.count_nonzero(visibility & last_vis)
        ratio = intersection / max(union, 1)
        return (ratio < self.kf_overlap and dist_check2) or dist_check

    def add_to_window(self, cur_idx: int, visibility: np.ndarray,
                      window: List[int]) -> Tuple[List[int], Optional[int]]:
        n_dont_touch = 2
        window = [cur_idx] + window
        removed = None
        to_remove = []
        for i in range(n_dont_touch, len(window)):
            kf_idx = window[i]
            vis = self.occ_aware_visibility[kf_idx]
            intersection = np.count_nonzero(visibility & vis)
            denom = min(np.count_nonzero(visibility), np.count_nonzero(vis))
            if intersection / max(denom, 1) <= self.kf_cutoff:
                to_remove.append(kf_idx)
        if to_remove:
            window.remove(to_remove[-1])
            removed = to_remove[-1]

        cur = self.cameras[cur_idx]
        kf0_wc = np.linalg.inv(cur.world_view_transform)
        if len(window) > self.window_size:
            inv_dist = []
            for i in range(n_dont_touch, len(window)):
                kf_i_cw = self.cameras[window[i]].world_view_transform
                inv_dists = []
                for j in range(n_dont_touch, len(window)):
                    if i == j:
                        continue
                    kf_j_wc = np.linalg.inv(
                        self.cameras[window[j]].world_view_transform)
                    inv_dists.append(
                        1.0 / (np.linalg.norm((kf_i_cw @ kf_j_wc)[:3, 3]) + 1e-6))
                k = np.sqrt(np.linalg.norm((kf_i_cw @ kf0_wc)[:3, 3]))
                inv_dist.append(k * sum(inv_dists))
            removed = window[n_dont_touch + int(np.argmax(inv_dist))]
            window.remove(removed)
        return window, removed

    def new_keyframe_depth(self, cam: Camera) -> np.ndarray:
        """Observed depth with invalid-RGB pixels zeroed."""
        img = cam.image_host if cam.image_host is not None else (
            cam.image.cpu().numpy())
        valid_rgb = img.sum(axis=0) > self.rgb_boundary_threshold
        depth = cam.depth.copy()
        depth[~valid_rgb] = 0.0
        return depth

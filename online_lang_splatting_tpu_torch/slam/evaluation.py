"""Trajectory and rendering evaluation (port of slam/evaluation.py).

* ATE RMSE via Umeyama similarity alignment (numpy).
* PSNR / SSIM / LPIPS on every `every`-th non-keyframe frame, rendered on
  the run's device; the rendered language maps are saved as lang/{idx}.npy
  for the LERF-protocol eval. LPIPS is the AlexNet metric (eval/lpips.py)
  when converted weights exist (config `Results.lpips_weights` or the
  environment's `OLS_LPIPS_WEIGHTS`, the npz of tools/convert_weights.py
  --lpips); otherwise the documented substitute 1 - MS-SSIM, and the
  metrics say which ("lpips_metric": "lpips_alex" | "msssim_proxy").

Each render sizes its own buffers, so the evaluation never truncates a
render to an earlier instance count.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from ..ops import losses


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning x (3,N) onto y (3,N): y ≈ c·R·x + t."""
    mx, my = x.mean(axis=1), y.mean(axis=1)
    xc, yc = x - mx[:, None], y - my[:, None]
    n = x.shape[1]
    cov = yc @ xc.T / n
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    var_x = np.square(xc).sum() / n
    c = float(np.trace(np.diag(d) @ s) / var_x) if with_scale else 1.0
    t = my - c * r @ mx
    return r, t, c


def ate_rmse(est_poses_w2c, gt_poses_w2c, align_scale=True) -> float:
    """RMS absolute trajectory error over camera centres (metres)."""
    est = np.stack([-p[:3, :3].T @ p[:3, 3] for p in est_poses_w2c], axis=1)
    gt = np.stack([-p[:3, :3].T @ p[:3, 3] for p in gt_poses_w2c], axis=1)
    r, t, c = umeyama_alignment(est, gt, with_scale=align_scale)
    aligned = c * r @ est + t[:, None]
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=0))))


def _w2c(r, t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3], m[:3, 3] = r, t
    return m


def eval_ate(cameras: dict, kf_indices, save_dir=None, iterations=0,
             final=False) -> float:
    """ATE RMSE over the keyframes (or every camera with `final`). Frames
    with non-finite pose estimates are dropped with a warning."""
    frames = sorted(kf_indices) if not final else sorted(cameras.keys())
    frames = [i for i in frames if i in cameras]
    bad = [i for i in frames
           if not (np.isfinite(cameras[i].r).all() and np.isfinite(cameras[i].t).all())]
    if bad:
        print(f"[eval_ate] WARNING: {len(bad)}/{len(frames)} keyframe poses "
              f"non-finite (first {bad[:5]}); scoring the rest")
        frames = [i for i in frames if i not in set(bad)]
    if len(frames) < 3:
        return float("nan")
    est = [_w2c(cameras[i].r, cameras[i].t) for i in frames]
    gt = [_w2c(cameras[i].r_gt, cameras[i].t_gt) for i in frames]
    rmse = ate_rmse(est, gt)
    if save_dir is not None:
        out = Path(save_dir) / "plot"
        out.mkdir(parents=True, exist_ok=True)
        with open(out / f"stats_{'final' if final else iterations}.json", "w") as f:
            json.dump({"rmse": rmse}, f, indent=4)
    return rmse


def make_lpips(config: dict, device):
    """(fn(img, ref) -> float, name): LPIPS on converted AlexNet weights if
    they exist, else the 1 - MS-SSIM substitute."""
    path = (config.get("Results", {}) or {}).get("lpips_weights") or os.environ.get(
        "OLS_LPIPS_WEIGHTS")
    if path and os.path.exists(path):
        from ..eval import lpips as lpips_mod

        params = lpips_mod.load_params(path, device)
        return (lambda a, b: float(lpips_mod.lpips(params, a, b))), "lpips_alex"
    return (lambda a, b: 1.0 - float(losses.ms_ssim(a, b))), "msssim_proxy"


@torch.no_grad()
def eval_rendering(slam, save_dir=None, tag="before_opt", every=5) -> dict:
    """PSNR / SSIM / LPIPS (+ saved language maps) on every `every`-th
    non-keyframe frame that was tracked."""
    from .camera import Camera
    from .renderer import activate, render

    fe, be = slam.frontend, slam.backend
    inputs = activate(be.params, be.aux.active)
    kf_set = set(fe.kf_indices)
    lpips_fn, lpips_name = make_lpips(slam.config, slam.device)
    psnrs, ssims, lpipss = [], [], []
    lang_dir = None
    if save_dir is not None:
        lang_dir = Path(save_dir) / tag / "lang"
        lang_dir.mkdir(parents=True, exist_ok=True)
    for idx in range(0, len(slam.dataset), every):
        if idx in kf_set or idx not in fe.cameras:
            continue
        cam = fe.cameras[idx]
        image = cam.image
        if image is None:  # non-keyframes drop their frames after tracking
            image = Camera.from_dataset(slam.dataset, idx, slam.device).image
        view = torch.as_tensor(_w2c(cam.r, cam.t), device=slam.device)
        out = render(inputs, view, slam.proj, slam.settings)
        img = torch.clamp(out.color, 0.0, 1.0)
        psnrs.append(float(losses.psnr(img, image)))
        ssims.append(float(losses.ssim(img, image)))
        lpipss.append(lpips_fn(img, image))
        if lang_dir is not None and out.language.shape[0] > 0:
            np.save(lang_dir / f"{idx:05d}.npy", out.language.cpu().numpy())
    metrics = {
        "mean_psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
        "mean_ssim": float(np.mean(ssims)) if ssims else float("nan"),
        "mean_lpips": float(np.mean(lpipss)) if lpipss else float("nan"),
        "lpips_metric": lpips_name,
        "tag": tag,
    }
    if save_dir is not None:
        with open(Path(save_dir) / f"metrics_{tag}.json", "w") as f:
            json.dump(metrics, f, indent=4)
    return metrics


def evaluate_run(slam, save_dir=None, tag="before_opt", every=5) -> dict:
    ate = eval_ate(slam.frontend.cameras, slam.frontend.kf_indices, save_dir, final=True)
    rendering = eval_rendering(slam, save_dir, tag=tag, every=every)
    rendering["ate_rmse"] = ate
    return rendering

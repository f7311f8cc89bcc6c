"""Trajectory error (port of slam/evaluation.py: umeyama_alignment,
ate_rmse), numpy only. Rendering evaluation comes with a later slice."""

from __future__ import annotations

import numpy as np


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

"""The benchmark's own scene: an analytic textured wall (z = 4) and floor
(y = 1.5) seen from a smooth orbit, ray cast on the device, and a writer
of its frames in the vMAP Replica-v2 layout (`rgb/rgb_{i}.png`, 16-bit
`depth/depth_{i}.png` at a depth scale, `traj_w_c.txt` of row-major 4x4
world-to-camera poses). The scene's geometry, trajectory and texture are
those of the program's synthetic dataset (its texture seed 0). The scene
is the same for every seed of a run: it is the traffic, and a texture
drawn per seed changed how many tracking iterations a frame took, and so
the work of a run.
"""

from __future__ import annotations

import math
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch


def texture() -> np.ndarray:
    return np.random.default_rng(0).uniform(0.1, 0.9, size=(8, 8, 3)).astype(np.float32)


def pose(i: int, trajectory_frames: int) -> np.ndarray:
    """World-to-camera pose of frame i (float64): a yaw of 0.5 rad and a
    small sweep over the trajectory's length."""
    t = i / max(trajectory_frames - 1, 1)
    c, s = math.cos(0.5 * t), math.sin(0.5 * t)
    w2c = np.eye(4)
    w2c[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    w2c[:3, 3] = [-0.15 * t, -0.05 * math.cos(2 * math.pi * t), 0.1 * t]
    return w2c


def render_frame(w2c: np.ndarray, tex: torch.Tensor, calib: dict):
    """(H, W, 3) colour in [0, 1] and (H, W) depth in metres (0 where the
    ray misses or the hit lies past 20 m), float32 on the texture's
    device."""
    dev = tex.device
    h, w = calib["height"], calib["width"]
    c2w = torch.as_tensor(np.linalg.inv(w2c), dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    dirs = torch.stack([(xs - calib["cx"]) / calib["fx"], (ys - calib["cy"]) / calib["fy"],
                        torch.ones_like(xs)], -1)
    dirs_w = (dirs[..., None, :] * c2w[:3, :3]).sum(-1)
    org = c2w[:3, 3]
    tz = (4.0 - org[2]) / torch.clamp(dirs_w[..., 2], min=1e-6)
    dy = dirs_w[..., 1]
    ty = (1.5 - org[1]) / torch.where(dy.abs() > 1e-6, dy, torch.full_like(dy, 1e6))
    ty = torch.where(ty > 0, ty, torch.full_like(ty, 1e6))
    tt = torch.minimum(tz, ty)
    pts = org + tt[..., None] * dirs_w
    u = torch.remainder(pts[..., 0], 4.0).abs() / 4.0
    v = torch.remainder(pts[..., 1] + pts[..., 2], 4.0).abs() / 4.0
    color = tex[(v * 7.99).long(), (u * 7.99).long()]
    depth = tt * dirs[..., 2]
    missed = (tt >= 1e5) | (depth > 20.0)
    depth = torch.where(missed, torch.zeros_like(depth), depth)
    color = torch.where(missed[..., None], torch.zeros_like(color), color)
    return color.clamp(0.0, 1.0), depth


def _png(img: np.ndarray) -> bytes:
    """PNG bytes of an 8-bit RGB (H, W, 3) or 16-bit grey (H, W) image,
    every row with the Up filter, zlib level 1."""
    h, w = img.shape[:2]
    if img.ndim == 3:
        color_type, bit_depth = 2, 8
        rows = img.reshape(h, -1)
    else:
        color_type, bit_depth = 0, 16
        rows = img.astype(">u2").view(np.uint8).reshape(h, -1)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # uint8 arithmetic wraps modulo 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], 1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def frame_u8(w2c, tex, calib, depth_scale):
    """One frame as written: (H, W, 3) uint8 colour and (H, W) uint16
    depth, numpy."""
    color, depth = render_frame(w2c, tex, calib)
    rgb = torch.round(color * 255.0).to(torch.uint8)
    d16 = torch.round(torch.clamp(depth * depth_scale, 0, 65535)).to(torch.int32)
    return rgb.cpu().numpy(), d16.cpu().numpy().astype(np.uint16)


def write_replicav2(root: Path, n_frames: int, trajectory_frames: int, calib: dict,
                    device) -> int:
    """Write frames 0..n_frames-1 under `root`; returns the bytes written."""
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    tex = torch.as_tensor(texture(), device=device)
    scale = float(calib["depth_scale"])
    poses = [pose(i, trajectory_frames) for i in range(n_frames)]

    def write(i, rgb, d16):
        a, b = _png(rgb), _png(d16)
        (root / "rgb" / f"rgb_{i}.png").write_bytes(a)
        (root / "depth" / f"depth_{i}.png").write_bytes(b)
        return len(a) + len(b)

    with ThreadPoolExecutor(4) as pool:  # zlib releases the interpreter lock
        futures = [pool.submit(write, i, *frame_u8(poses[i], tex, calib, scale))
                   for i in range(n_frames)]
        total = sum(f.result() for f in futures)
    (root / "traj_w_c.txt").write_text(
        "".join(" ".join(f"{v:.9f}" for v in p.reshape(-1)) + "\n" for p in poses))
    return total

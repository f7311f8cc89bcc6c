"""Fuse rendered or colourised 3-channel maps and depth into a TSDF mesh
(port of tsdf-fusion/dim3_recon.py).

Volume bounds come from the depth frustums; every Nth map is integrated
into a 3-channel volume on the device, and `semantic_mesh.ply` (marching
cubes) and `semantic_pc.ply` (uchar colours) are written.

    python -m online_lang_splatting_tpu_torch.tools.dim3_recon \
        --color-dir <dir of {i}.npy (3,H,W) | *.png> \
        --dataset-config configs/rgbd/replicav2/room0.yaml --out out/ [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def load_color(path: str, hw) -> np.ndarray:
    """(3, H, W) float in [0, 1] from .npy (3, H, W) / (H, W, 3) or a PNG,
    resized to `hw` by nearest neighbour (cv2 INTER_NEAREST's floor rule)."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 3 and arr.shape[0] in (3,) and arr.shape[0] < arr.shape[-1]:
            pass  # already (3, H, W)
        elif arr.ndim == 3 and arr.shape[-1] == 3:
            arr = arr.transpose(2, 0, 1)
        if arr.max() > 1.5:
            arr = arr / 255.0
    else:
        from ..utils.png import read_rgb8

        arr = read_rgb8(path).astype(np.float32).transpose(2, 0, 1) / 255.0
    h, w = hw
    if arr.shape[1:] != (h, w):
        arr = F.interpolate(torch.as_tensor(np.ascontiguousarray(arr))[None], size=(h, w),
                            mode="nearest")[0].numpy()
    return arr


def numeric_key(path: str) -> int:
    nums = re.findall(r"\d+", Path(path).stem)
    return int(nums[-1]) if nums else 0


def run(color_files: dict, args, gt_tag: str = "") -> dict:
    from .. import entry_device
    from ..slam.config import load_config
    from ..slam.datasets import load_dataset
    from ..tsdf.fusion import TSDFVolume, estimate_bounds
    from ..tsdf.meshing import extract_mesh, write_mesh_ply
    from ..utils.ply import write_ply

    device = entry_device(args.device)
    dataset = load_dataset(load_config(args.dataset_config))
    intr = (dataset.fx, dataset.fy, dataset.cx, dataset.cy)
    frames = sorted(color_files)[:: args.every]
    if not frames:
        raise FileNotFoundError("no color frames found")

    depths, poses = [], []
    for idx in frames:
        _, depth, pose, _, _ = dataset[idx]
        depths.append(depth)
        poses.append(pose)
    bounds = estimate_bounds(depths, intr, poses)
    print("volume bounds:", bounds.tolist())

    vol = TSDFVolume(bounds, args.voxel, n_channels=3, device=device)
    for i, idx in enumerate(frames):
        vol.integrate(load_color(color_files[idx], depths[i].shape), depths[i], intr, poses[i])
        if i % 20 == 0:
            print(f"integrated {i + 1}/{len(frames)}")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    pts, feats = vol.get_point_cloud()
    fields = {c: pts[:, j].astype(np.float32) for j, c in enumerate("xyz")}
    for j, c in enumerate(("red", "green", "blue")):
        fields[c] = (np.clip(feats[:, j], 0, 1) * 255).astype(np.uint8)
    write_ply(str(out / f"{gt_tag}semantic_pc.ply"), fields)

    verts, faces, vfeat = extract_mesh(vol)
    write_mesh_ply(str(out / f"{gt_tag}semantic_mesh.ply"), verts, faces,
                   colors=np.clip(vfeat[:, :3], 0, 1))
    print(f"wrote {out}/{gt_tag}semantic_mesh.ply ({len(verts)} verts, {len(faces)} tris)")
    return {"frames": frames, "bounds": bounds.tolist(), "points": len(pts),
            "verts": len(verts), "faces": len(faces),
            "pc": str(out / f"{gt_tag}semantic_pc.ply"),
            "mesh": str(out / f"{gt_tag}semantic_mesh.ply")}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--color-dir", required=True,
                   help="dir of 3-channel maps: {i}.npy or *.png")
    p.add_argument("--dataset-config", required=True)
    p.add_argument("--voxel", type=float, default=0.02)
    p.add_argument("--every", type=int, default=5)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    files = glob.glob(str(Path(args.color_dir) / "*.npy")) or glob.glob(
        str(Path(args.color_dir) / "*.png"))
    return run({numeric_key(f): f for f in files}, args)


if __name__ == "__main__":
    main()

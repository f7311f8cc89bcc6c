"""Fuse rendered 15-d language maps and depths into a semantic point cloud
(port of tsdf-fusion/dim15_recon.py).

Volume bounds come from the depth frustums; every Nth rendered
`<tag>/lang/{idx}.npy` map of a run directory is integrated with the
dataset's depth and pose into a 15-channel TSDF volume on the device, and
the surface is written as `semantic_pc.ply` with per-point language codes
(f_0 .. f_14); `--mesh` adds `semantic_mesh.ply`, marching cubes coloured
by the codes' first three principal components.

    python -m online_lang_splatting_tpu_torch.tools.dim15_recon \
        --run-dir results/<stamp> --dataset-config configs/rgbd/replicav2/room0.yaml \
        [--voxel 0.02] [--every 5] [--mesh] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run-dir", required=True,
                   help="run directory containing <tag>/lang/*.npy")
    p.add_argument("--dataset-config", required=True)
    p.add_argument("--tag", default="before_opt")
    p.add_argument("--voxel", type=float, default=0.02)
    p.add_argument("--every", type=int, default=5)
    p.add_argument("--out", default=None)
    p.add_argument("--mesh", action="store_true",
                   help="also export semantic_mesh.ply (marching cubes)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import entry_device
    from ..slam.config import load_config
    from ..slam.datasets import load_dataset
    from ..tsdf.fusion import TSDFVolume, estimate_bounds
    from ..utils.ply import write_ply

    device = entry_device(args.device)
    dataset = load_dataset(load_config(args.dataset_config))
    intr = (dataset.fx, dataset.fy, dataset.cx, dataset.cy)

    lang_dir = Path(args.run_dir) / args.tag / "lang"
    lang_files = {int(Path(f).stem): f for f in glob.glob(str(lang_dir / "*.npy"))}
    frames = sorted(lang_files)[:: max(args.every // 5, 1)]
    if not frames:
        raise FileNotFoundError(f"no lang maps under {lang_dir}")

    depths, poses = [], []
    for idx in frames:
        _, depth, pose, _, _ = dataset[idx]
        depths.append(depth)
        poses.append(pose)
    bounds = estimate_bounds(depths, intr, poses)
    print("volume bounds:", bounds.tolist())

    lang0 = np.load(lang_files[frames[0]])
    vol = TSDFVolume(bounds, args.voxel, n_channels=lang0.shape[0], device=device)
    for i, idx in enumerate(frames):
        lang = torch.as_tensor(np.load(lang_files[idx]), dtype=torch.float32, device=device)
        h, w = depths[i].shape
        if tuple(lang.shape[1:]) != (h, w):
            # Bilinear with half-pixel centres (cv2.resize INTER_LINEAR).
            lang = F.interpolate(lang[None], size=(h, w), mode="bilinear",
                                 align_corners=False)[0]
        vol.integrate(lang, depths[i], intr, poses[i])
        if i % 10 == 0:
            print(f"integrated {i + 1}/{len(frames)}")

    pts, feats = vol.get_point_cloud()
    print(f"surface points: {len(pts)}")
    out = args.out or str(Path(args.run_dir) / "semantic_pc.ply")
    fields = {c: pts[:, j].astype(np.float32) for j, c in enumerate("xyz")}
    for j in range(feats.shape[1]):
        fields[f"f_{j}"] = feats[:, j].astype(np.float32)
    write_ply(out, fields)
    print(f"wrote {out}")
    result = {"frames": frames, "bounds": bounds.tolist(), "dims": vol.dims.tolist(),
              "points": len(pts), "pc": out}

    if args.mesh:
        from ..tsdf.meshing import extract_mesh, write_mesh_ply

        verts, faces, vfeat = extract_mesh(vol)
        mesh_out = str(Path(out).with_name("semantic_mesh.ply"))
        # The first three feature channels as vertex colours (PCA for > 3).
        if vfeat.shape[1] > 3:
            c = vfeat - vfeat.mean(0)
            _, _, vt = np.linalg.svd(c[:: max(len(c) // 5000, 1)], full_matrices=False)
            c = c @ vt[:3].T
            c = (c - c.min(0)) / np.maximum(c.max(0) - c.min(0), 1e-9)
        else:
            c = vfeat[:, :3]
        write_mesh_ply(mesh_out, verts, faces, colors=c)
        print(f"wrote {mesh_out} ({len(verts)} verts, {len(faces)} tris)")
        result.update(mesh=mesh_out, verts=len(verts), faces=len(faces))
    return result


if __name__ == "__main__":
    main()

"""Fuse a dataset's ground-truth semantic-colour frames into a TSDF mesh
(port of tsdf-fusion/dim3_recon_gt.py): the pipeline of `dim3_recon` on
the scene's `semantic_color_*.png` frames with the dataset's poses, which
writes the `GT_semantic_{pc,mesh}.ply` that the 3D evaluation compares
against.

    python -m online_lang_splatting_tpu_torch.tools.dim3_recon_gt \
        --semantic-color-dir <scene>/imap/00/semantic_color \
        --dataset-config configs/rgbd/replicav2/room0.yaml --out out/ [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

from .dim3_recon import numeric_key, run


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--semantic-color-dir", required=True)
    p.add_argument("--dataset-config", required=True)
    p.add_argument("--voxel", type=float, default=0.02)
    p.add_argument("--every", type=int, default=5)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    files = glob.glob(str(Path(args.semantic_color_dir) / "*.png")) or (
        glob.glob(str(Path(args.semantic_color_dir) / "*.npy")))
    args.color_dir = args.semantic_color_dir
    return run({numeric_key(f): f for f in files}, args, gt_tag="GT_")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Online Language Splatting SLAM — PyTorch/CUDA port, single-thread mode.

    python slam_torch.py --config configs/synthetic/replica_scale.yaml --max-frames 8

Mirrors `slam.py` (the JAX package's entry point) for the slice the port
covers: single-thread tracking + mapping on the synthetic scene, through
the hand-written Hopper blend kernels. `--device cuda` (the default) needs
a CUDA device and never falls back to the CPU.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from online_lang_splatting_tpu_torch import pin_f32_matmul
    from online_lang_splatting_tpu_torch.slam.config import load_config
    from online_lang_splatting_tpu_torch.slam.system import SLAM

    # Full float32 for matmuls and convolutions (TF32 off), as the JAX
    # reference pins "highest" precision.
    pin_f32_matmul()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda requested but CUDA is not available")
    config = load_config(args.config)
    slam = SLAM(config, device=args.device)
    slam.run_single_thread(max_frames=args.max_frames)
    print(f"Total FPS: {slam.fps:.3f}")
    total = sum(slam.phase_times.values())
    breakdown = ", ".join(f"{k} {v:.2f}s" for k, v in slam.phase_times.items())
    print(f"Phase wall-clock ({total:.2f}s accounted): {breakdown}")
    print(f"Keyframes: {len(slam.frontend.kf_indices)}, "
          f"gaussians: {int(slam.backend.aux.active.sum())}")
    return slam


if __name__ == "__main__":
    main()

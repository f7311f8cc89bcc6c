#!/usr/bin/env python
"""Online Language Splatting SLAM — PyTorch/CUDA port, single-thread mode.

    python slam_torch.py --config configs/synthetic/replica_scale.yaml --max-frames 8 \
        [--weights-dir DIR]

Mirrors `slam.py` (the JAX package's entry point) for the slice the port
covers: single-thread tracking + mapping on the synthetic scene, through
the hand-written Hopper blend kernels. With `language.language_train` set,
the ConvNeXt-L CLIP extractor, HR head and autoencoder (and, in two-stage
mode, the online autoencoder) supervise the language channels; their
weights are read from `--weights-dir` as the npz trees
tools/convert_weights.py writes (clip_visual.npz, hr_net.npz,
autoencoder.npz), each missing file falling back to seeded random weights
with a warning. `--device cuda` (the default) needs a CUDA device and
never falls back to the CPU.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--weights-dir", type=str, default=None,
                        help="directory of tools/convert_weights.py npz trees")
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
    lang_extractor = online_ae = None
    if config.get("language", {}).get("language_train", False):
        from online_lang_splatting_tpu_torch.models.checkpoints import load_extractor_from_dir

        lang_extractor, online_ae = load_extractor_from_dir(
            args.weights_dir, config, device=args.device)
    slam = SLAM(config, lang_extractor=lang_extractor, online_ae=online_ae,
                device=args.device)
    slam.run_single_thread(max_frames=args.max_frames)
    print(f"Total FPS: {slam.fps:.3f}")
    total = sum(slam.phase_times.values())
    breakdown = ", ".join(f"{k} {v:.2f}s" for k, v in slam.phase_times.items())
    print(f"Phase wall-clock ({total:.2f}s accounted): {breakdown}; of which "
          f"language extraction {slam.backend.lang_extract_s:.2f}s")
    print(f"Keyframes: {len(slam.frontend.kf_indices)}, "
          f"gaussians: {int(slam.backend.aux.active.sum())}")
    return slam


if __name__ == "__main__":
    main()

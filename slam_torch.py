#!/usr/bin/env python
"""Online Language Splatting SLAM — PyTorch/CUDA port.

    python slam_torch.py --config configs/rgbd/replicav2/room0.yaml --eval \
        [--max-frames N] [--weights-dir DIR] [--checkpoint-every N] [--resume CKPT]

The flags and flow of `slam.py` (the JAX package's entry point): the
dataset of the config (Replica v1 / v2, TUM, EuRoC, RealSense or the
synthetic scene) is decoded ahead of the loop, SLAM runs single-threaded
or threaded as the config says, through the hand-written Hopper blend
kernels. `--eval` forces the evaluation settings (results saved to a
timestamped directory under `Results.save_dir` with `config.yml`, no GUI,
eval rendering); the run is then evaluated (ATE, PSNR, SSIM, LPIPS or its
substitute, language maps), written as `gaussians_final.ply`, colour-refined
for `Results.color_refinement_iters` iterations (default 26000), evaluated
again and written as `gaussians_final_after_opt.ply`. `--checkpoint-every
N` saves a resumable snapshot at the first keyframe N or more frames after
the previous one, `--resume CKPT` continues from one. With
`language.language_train` set, the ConvNeXt-L CLIP extractor, HR head and
autoencoder (and, in two-stage mode, the online autoencoder) supervise the
language channels; their weights are read from `--weights-dir` as the npz
trees tools/convert_weights.py writes (clip_visual.npz, hr_net.npz,
autoencoder.npz), each missing file falling back to seeded random weights
with a warning. `--device cuda` (the default) needs a CUDA device and never
falls back to the CPU.
"""

from __future__ import annotations

import argparse
from datetime import datetime
from pathlib import Path

import yaml


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--weights-dir", type=str, default=None,
                        help="directory of tools/convert_weights.py npz trees")
    parser.add_argument("--checkpoint-every", type=int, default=None,
                        help="save a resumable SLAM snapshot every N frames")
    parser.add_argument("--resume", type=str, default=None,
                        help="resume from a ckpt_*.npz snapshot")
    args = parser.parse_args(argv)

    from online_lang_splatting_tpu_torch import entry_device
    from online_lang_splatting_tpu_torch.slam.config import load_config
    from online_lang_splatting_tpu_torch.slam.system import SLAM

    # Full float32 for matmuls and convolutions (TF32 off), as the JAX
    # reference pins "highest" precision; no CPU fallback.
    entry_device(args.device)
    config = load_config(args.config)
    results = config.setdefault("Results", {})
    if args.eval:
        print("Running in evaluation mode")
        results.update(save_results=True, use_gui=False, eval_rendering=True)

    save_dir = None
    if results.get("save_results", False):
        stamp = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
        save_dir = Path(results.get("save_dir", "results")) / stamp
        save_dir.mkdir(parents=True, exist_ok=True)
        with open(save_dir / "config.yml", "w") as f:
            yaml.dump(config, f)

    lang_extractor = online_ae = None
    if config.get("language", {}).get("language_train", False):
        from online_lang_splatting_tpu_torch.models.checkpoints import load_extractor_from_dir

        lang_extractor, online_ae = load_extractor_from_dir(
            args.weights_dir, config, device=args.device)
    slam = SLAM(config, lang_extractor=lang_extractor, online_ae=online_ae,
                device=args.device, save_dir=save_dir)
    start_frame = 0
    if args.resume:
        from online_lang_splatting_tpu_torch.slam import checkpoint

        start_frame = checkpoint.load_state(slam, args.resume)
        print(f"Resumed from {args.resume} at frame {start_frame}")
    slam.run(max_frames=args.max_frames, start_frame=start_frame,
             checkpoint_every=args.checkpoint_every)
    print(f"Total FPS: {slam.fps:.3f}")
    if slam.phase_times:  # single-thread mode
        total = sum(slam.phase_times.values())
        breakdown = ", ".join(f"{k} {v:.2f}s" for k, v in slam.phase_times.items())
        print(f"Phase wall-clock ({total:.2f}s accounted): {breakdown}; of which "
              f"language extraction {slam.backend.lang_extract_s:.2f}s")
    print(f"Keyframes: {len(slam.frontend.kf_indices)}, "
          f"gaussians: {int(slam.backend.aux.active.sum())}")

    if results.get("eval_rendering", False):
        from online_lang_splatting_tpu_torch.slam import evaluation
        from online_lang_splatting_tpu_torch.utils.ply import save_gaussians_ply

        be = slam.backend
        slam.metrics = {"before_opt": evaluation.evaluate_run(slam, save_dir)}
        print(slam.metrics["before_opt"])
        if save_dir is not None:
            save_gaussians_ply(save_dir / "gaussians_final.ply", be.params, be.aux)
        slam.finalize(color_refinement_iters=results.get("color_refinement_iters", 26000))
        slam.metrics["after_opt"] = evaluation.evaluate_run(slam, save_dir, tag="after_opt")
        print(slam.metrics["after_opt"])
        if save_dir is not None:
            save_gaussians_ply(save_dir / "gaussians_final_after_opt.ply", be.params, be.aux)
            if be.online_ae is not None:
                from online_lang_splatting_tpu_torch.convert import online_ae_to_numpy
                from online_lang_splatting_tpu_torch.models.checkpoints import save_npz_tree

                save_npz_tree(save_dir / "online_ae.npz",
                              {"params": online_ae_to_numpy(be.online_ae.model.state_dict())})
    return slam


if __name__ == "__main__":
    main()

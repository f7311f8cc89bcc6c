"""The replica-scale whole-run gate of the port (port of
tools/replica_scale_gate.py): SLAM on the replica-scale synthetic config
with no language extractor (zero supervision, so the language-L1 gate
keeps its meaning), then quality gates on PSNR, keyframe ATE and the
rendered language map's L1, and one JSON row with the JAX tool's keys plus
`device` (the card's name and power limit).

    python -m online_lang_splatting_tpu_torch.tools.replica_scale_gate \
        [--max-frames 40] [--config FILE] [--out FILE] [--device cuda]

`blend_chunk` is a knob of the JAX package's Pallas kernel and is null
here. Every render sizes its own buffers, so the evaluation cannot render
with a stale instance bucket (ROADMAP queue C).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]

# The JAX tool's gates: regression locks on the 40-frame run, not quality
# claims. PSNR on this scene is coverage-limited (non-keyframe views see
# orbit-edge regions no keyframe observed).
GATE_PSNR = 11.0       # rendered non-keyframe frames vs ground truth
GATE_ATE = 0.012       # m, keyframe ATE RMSE (scene scale ~5 m)
GATE_LANG_L1 = 0.001   # rendered language map L1 vs the supervision cache


def _device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--max-frames", type=int, default=40)
    ap.add_argument("--config", type=str,
                    default=str(REPO / "configs/synthetic/replica_scale.yaml"))
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--no-gates", action="store_true",
                    help="record metrics without failing on thresholds")
    ap.add_argument("--motion-model", choices=["static", "cv"], default=None,
                    help="override Training.motion_model")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable dataset + camera prefetch threads")
    ap.add_argument("--track-best", choices=["on", "off"], default=None,
                    help="override Training.tracking_best_pose")
    ap.add_argument("--plateau", type=float, default=None,
                    help="override Training.tracking_plateau_rtol")
    ap.add_argument("--tag", type=str, default=None, help="label recorded in the row")
    ap.add_argument("--lr-decay", type=float, default=None,
                    help="override Training.tracking_lr_decay")
    ap.add_argument("--use-gt-pose", action="store_true",
                    help="track with ground-truth poses")
    args = ap.parse_args(argv)

    from online_lang_splatting_tpu_torch.slam import evaluation
    from online_lang_splatting_tpu_torch.slam.backend import resize_bilinear
    from online_lang_splatting_tpu_torch.slam.config import load_config
    from online_lang_splatting_tpu_torch.slam.renderer import activate, render
    from online_lang_splatting_tpu_torch.slam.system import SLAM

    config = load_config(args.config)
    tr = config["Training"]
    if args.motion_model is not None:
        tr["motion_model"] = args.motion_model
    if args.no_prefetch:
        config["Dataset"]["prefetch"] = False
    if args.track_best is not None:
        tr["tracking_best_pose"] = args.track_best == "on"
    if args.plateau is not None:
        tr["tracking_plateau_rtol"] = args.plateau
    if args.lr_decay is not None:
        tr["tracking_lr_decay"] = args.lr_decay
    if args.use_gt_pose:
        tr["use_gt_pose"] = True
    t0 = time.time()
    slam = SLAM(config, device=args.device)
    slam.run(max_frames=args.max_frames)
    wall = time.time() - t0
    fe, be = slam.frontend, slam.backend
    n_frames = args.max_frames

    # --- quality ---------------------------------------------------------
    psnr = evaluation.eval_rendering(slam)["mean_psnr"]
    ate = float(evaluation.eval_ate(fe.cameras, fe.kf_indices))
    # ATE over keyframe prefixes, each with its own alignment: gradual
    # drift or a jump.
    kfs = sorted(fe.kf_indices)
    ate_curve = [[int(kfs[k - 1]), round(float(evaluation.eval_ate(fe.cameras, kfs[:k])), 5)]
                 for k in range(3, len(kfs) + 1)]
    # Each keyframe's rendered language map against its cached supervision
    # (resized), as the mapping loss compares them.
    inputs = activate(be.params, be.aux.active)
    lang_l1 = []
    with torch.no_grad():
        for idx in fe.kf_indices:
            cam = be.viewpoints.get(idx)
            if cam is None or cam.gt_lang_feat is None:
                continue
            view = torch.as_tensor(cam.world_view_transform, device=slam.device)
            out = render(inputs, view, slam.proj, be.settings)
            if out.language.shape[0] == 0:
                continue
            gt = resize_bilinear(cam.gt_lang_feat, (cam.height, cam.width))
            lang_l1.append(float(torch.abs(out.language - gt).mean()))
    lang_l1_mean = float(np.mean(lang_l1)) if lang_l1 else float("nan")

    # --- tracking budget --------------------------------------------------
    iters = np.asarray(fe.track_iters, np.int64)
    budget = tr["tracking_itr_num"]
    track_stats = {
        "frames": int(iters.size),
        "mean_iters": float(iters.mean()) if iters.size else None,
        "median_iters": float(np.median(iters)) if iters.size else None,
        "p90_iters": float(np.percentile(iters, 90)) if iters.size else None,
        "budget": budget,
        "budget_hit_frac": float((iters >= budget).mean()) if iters.size else None,
    }
    head = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                          capture_output=True, text=True).stdout.strip()
    result = {
        "tag": args.tag,
        "head": head,
        "motion_model": tr.get("motion_model", "static"),
        "prefetch": not args.no_prefetch,
        "track_best": bool(tr.get("tracking_best_pose", False)),
        "plateau_rtol": float(tr.get("tracking_plateau_rtol", 0.0)),
        "lr_decay": float(tr.get("tracking_lr_decay", 1.0)),
        "blend_chunk": None,
        "frames": n_frames,
        "keyframes": len(fe.kf_indices),
        "gaussians": int(be.aux.active.sum()),
        "wall_s": round(wall, 1),
        "fps": round(n_frames / wall, 4),
        "phase_times": {k: round(v, 1) for k, v in slam.phase_times.items()},
        "use_gt_pose": bool(args.use_gt_pose),
        "psnr": round(psnr, 2),
        "ate": round(ate, 5),
        "ate_curve": ate_curve,
        "lang_l1": round(lang_l1_mean, 5),
        "tracking": track_stats,
        "gates": {"psnr_min": GATE_PSNR, "ate_max": GATE_ATE, "lang_l1_max": GATE_LANG_L1},
        "device": _device_name(slam.device),
    }
    ok = (psnr > GATE_PSNR and ate < GATE_ATE
          and (np.isnan(lang_l1_mean) or lang_l1_mean < GATE_LANG_L1))
    result["gates_ok"] = bool(ok)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if not ok and not args.no_gates:
        print("QUALITY GATES FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end open-vocabulary mIoU gate on the synthetic scene (port of
tools/synthetic_miou_gate.py): SLAM with class-embedding language
supervision from the scene's exact geometry -> rendered 15-d maps -> (one-
or two-stage) decode -> LERF relevancy -> IoU and localization, through
the port's evaluation entry points. Prints one JSON row with the JAX
tool's keys plus `device` (the card's name and power limit).

    python -m online_lang_splatting_tpu_torch.tools.synthetic_miou_gate   # smoke scale, 2-stage
    python -m online_lang_splatting_tpu_torch.tools.synthetic_miou_gate --stage 1
    python -m online_lang_splatting_tpu_torch.tools.synthetic_miou_gate \
        --config configs/synthetic/replica_scale.yaml --max-frames 40 --feat-hw 192

The gates are regression locks at the given scale, not quality claims: at
smoke scale (96x64) the protocol's 30-px box blur dominates the small floor
region; at the 1200x680 replica scale the blur is proportionally what the
reference's evaluation resolution gives.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# The JAX tool's locks: per stage at smoke scale, 0.7 at replica scale with
# >= 8 distinct queries and >= 8 scored frames.
DEFAULT_MIN_MIOU = {1: 0.25, 2: 0.35}
REPLICA_SCALE_MIN_MIOU = 0.7
DEFAULT_MIN_LOC = 0.75


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="configs/synthetic/smoke.yaml")
    ap.add_argument("--stage", type=int, default=2, choices=(1, 2))
    ap.add_argument("--max-frames", type=int, default=12)
    ap.add_argument("--every", type=int, default=3, help="eval/annotation cadence (non-KF frames)")
    ap.add_argument("--feat-hw", type=int, default=24)
    ap.add_argument("--ae-steps", type=int, default=300)
    ap.add_argument("--min-miou", type=float, default=None)
    ap.add_argument("--min-loc", type=float, default=DEFAULT_MIN_LOC)
    ap.add_argument("--min-queries", type=int, default=None,
                    help="minimum distinct queries scored (default 8 at replica scale, "
                         "1 at smoke scale)")
    ap.add_argument("--min-frames", type=int, default=None,
                    help="minimum frames evaluated (default 8 at replica scale, 2 at smoke scale)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-gates", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import entry_device
    from ..eval.synthetic_miou import run_synthetic_miou
    from ..slam.config import load_config
    from .replica_scale_gate import _device_name

    device = entry_device(args.device)
    config_path = Path(args.config)
    config = load_config(str(config_path if config_path.is_absolute() else REPO / config_path))
    config["language"]["feat_hw"] = args.feat_hw
    config["language"]["allow_zero_supervision"] = False

    t0 = time.time()
    result = run_synthetic_miou(config, max_frames=args.max_frames, every=args.every,
                                stage=args.stage, train_steps=args.ae_steps, device=device)
    replica_scale = "replica_scale" in args.config
    min_miou = (args.min_miou if args.min_miou is not None
                else (REPLICA_SCALE_MIN_MIOU if replica_scale else DEFAULT_MIN_MIOU[args.stage]))
    min_queries = (args.min_queries if args.min_queries is not None
                   else (8 if replica_scale else 1))
    min_frames = args.min_frames if args.min_frames is not None else (8 if replica_scale else 2)
    result.update(
        wall_s=round(time.time() - t0, 1),
        config=args.config,
        gates={"min_miou": min_miou, "min_loc": args.min_loc,
               "min_queries": min_queries, "min_frames": min_frames},
        device=_device_name(device),
    )
    ok = (result["miou"] >= min_miou
          and result["localization_acc"] >= args.min_loc
          and result["distinct_queries"] >= min_queries
          and result["frames_scored"] >= min_frames)
    result["gates_ok"] = bool(ok)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if not ok and not args.no_gates:
        print("MIOU GATES FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

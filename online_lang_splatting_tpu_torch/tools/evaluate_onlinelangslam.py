"""2D language evaluation of the two-stage pipeline: mIoU and localization
accuracy (port of eval/evaluate_onlinelangslam.py).

Rendered 15-d maps (`<run>/<tag>/lang/{idx}.npy`) are decoded through the
online 15 -> 32 decoder and the offline 32 -> 768 decoder, then scored with
the LERF relevancy protocol against the annotations, on the device.

    python -m online_lang_splatting_tpu_torch.tools.evaluate_onlinelangslam \
        --feat-dir run/before_opt/lang --ann ann.json --weights-dir <npz dir> \
        --online-ae online_ae.npz [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None, single_stage: bool = False) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feat-dir", required=True, help="directory of rendered lang/{idx}.npy maps")
    p.add_argument("--ann", required=True, help="annotation json")
    p.add_argument("--weights-dir", required=True)
    p.add_argument("--online-ae", default=None)
    p.add_argument("--mask-thresh", type=float, default=0.5)
    p.add_argument("--eval-h", type=int, default=480)
    p.add_argument("--eval-w", type=int, default=640)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import entry_device
    from ..eval.lerf_eval import evaluate_scene
    from ..models.checkpoints import load_extractor_from_dir
    from .evaluation_3d import load_online_ae, load_relevancy

    device = entry_device(args.device)
    extractor, _ = load_extractor_from_dir(
        args.weights_dir, {"language": {"single_stage": single_stage}}, device=device)
    online_ae = None
    if not single_stage and args.online_ae:
        online_ae = load_online_ae(args.online_ae, device)
    relevancy = load_relevancy(args.weights_dir, device)
    metrics = evaluate_scene(args.feat_dir, args.ann, extractor, relevancy, online_ae,
                             eval_size=(args.eval_h, args.eval_w), mask_thresh=args.mask_thresh)
    print(json.dumps(metrics, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()

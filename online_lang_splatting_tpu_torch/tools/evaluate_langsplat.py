"""2D language evaluation of LangSplat outputs: mIoU and localization
accuracy (port of eval/evaluate_langsplat.py).

Three feature levels rendered to per-frame .npy maps (LangSplat's (H, W,
code) layout, `renders_npy`) are resized to the evaluation size, decoded
to CLIP space through the offline autoencoder and scored with the shared
LERF relevancy protocol (mask threshold 0.4), on the device.

    python -m online_lang_splatting_tpu_torch.tools.evaluate_langsplat \
        --root-dir /data/langsplat/room0 --dataset-name room0 --weights-dir <npz dir>

or with explicit level directories:

    python -m online_lang_splatting_tpu_torch.tools.evaluate_langsplat \
        --feat-dirs lvl1 lvl2 lvl3 --ann labels/ --weights-dir <npz dir>
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root-dir", default=None,
                   help="LangSplat run root (<root>/<name>_{1,2,3}/train/ours_None/renders_npy)")
    p.add_argument("--dataset-name", default=None)
    p.add_argument("--label-name", default="label")
    p.add_argument("--feat-dirs", nargs="+", default=None,
                   help="explicit per-level feature dirs (overrides --root-dir)")
    p.add_argument("--ann", default=None,
                   help="annotation json or labelme folder (default: <root>/<label-name>)")
    p.add_argument("--weights-dir", required=True,
                   help="converted npz weights (autoencoder + clip_text)")
    p.add_argument("--mask-thresh", type=float, default=0.4)
    p.add_argument("--eval-h", type=int, default=480)
    p.add_argument("--eval-w", type=int, default=640)
    p.add_argument("--chw", action="store_true",
                   help="feature .npy stored (C, H, W) instead of LangSplat's (H, W, C)")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.feat_dirs:
        feat_dirs = args.feat_dirs
    else:
        if not (args.root_dir and args.dataset_name):
            p.error("--feat-dirs or (--root-dir + --dataset-name) required")
        feat_dirs = [os.path.join(args.root_dir, f"{args.dataset_name}_{i}",
                                  "train/ours_None/renders_npy") for i in range(1, 4)]
    ann = args.ann or os.path.join(args.root_dir, args.label_name)

    from .. import entry_device
    from ..eval.lerf_eval import evaluate_scene_multilevel
    from .evaluation_3d import load_decoder, load_relevancy

    device = entry_device(args.device)
    metrics = evaluate_scene_multilevel(
        feat_dirs, ann, load_decoder(args.weights_dir, None, device),
        load_relevancy(args.weights_dir, device), eval_size=(args.eval_h, args.eval_w),
        mask_thresh=args.mask_thresh, hwc=not args.chw)
    print(json.dumps(metrics, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()

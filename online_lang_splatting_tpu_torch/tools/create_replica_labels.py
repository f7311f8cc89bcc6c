"""GT query annotations from Replica semantic renderings (port of
eval/create_replica_labels.py), without OpenCV.

Reads the seed frames' semantic_class_{i}.png label images (8- or 16-bit
PNG, through the port's decoder), selects the scene's top-K most frequent
classes, and writes per-frame class masks (.npy) and bounding boxes of
their 8-connected components for the LERF 2D evaluation:
<out>/ann.json = {frame: {class: {mask_file, bboxes}}}.

    python -m online_lang_splatting_tpu_torch.tools.create_replica_labels \
        --semantic-config <scene>/semantic_config.yaml \
        --frames 5,20,120,270,... --out labels/room0
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

import numpy as np

from ..eval.contours import connected_components
from ..utils.png import read_png

# Reference seed frames (create_replica_labels.py:57-58).
DEFAULT_FRAMES = [5, 20, 120, 270, 340, 410, 490, 560, 630, 700, 780, 850,
                  920, 1050, 1410, 1850]


def load_class_names(semantic_config: str) -> dict[int, str]:
    import yaml

    with open(semantic_config) as f:
        cfg = yaml.safe_load(f)
    names = {}
    for cls in cfg.get("classes", []):
        names[int(cls["id"])] = cls["name"]
    return names


def get_top_labels(class_names, seg_dir: Path, k: int = 10,
                   ignore=("wall", "floor", "ceiling", "undefined", "")):
    counts: Counter = Counter()
    for f in sorted(seg_dir.glob("semantic_class_*.png"))[::10]:
        seg = read_png(f)
        ids, c = np.unique(seg, return_counts=True)
        for i, n in zip(ids, c):
            name = class_names.get(int(i), "")
            if name not in ignore:
                counts[int(i)] += int(n)
    return [cid for cid, _ in counts.most_common(k)]


def masks_to_bboxes(mask: np.ndarray, min_area: int = 64) -> list[list[int]]:
    n, comp = connected_components(mask.astype(np.uint8))
    boxes = []
    for i in range(1, n):
        ys, xs = np.nonzero(comp == i)
        if len(xs) < min_area:
            continue
        boxes.append([int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())])
    return boxes


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--semantic-config", required=True)
    p.add_argument("--frames", default=",".join(map(str, DEFAULT_FRAMES)))
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    seg_dir = Path(args.semantic_config).parent / "semantic_class"
    class_names = load_class_names(args.semantic_config)
    top = get_top_labels(class_names, seg_dir, args.top_k)
    print("top classes:", [class_names[i] for i in top])

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ann = {}
    for idx in (int(x) for x in args.frames.split(",")):
        f = seg_dir / f"semantic_class_{idx}.png"
        if not f.exists():
            continue
        seg = read_png(f).astype(np.int32)
        frame_key = f"{idx:05d}"
        frame_ann = {}
        for cid in top:
            mask = seg == cid
            if mask.sum() < 256:
                continue
            name = class_names[cid]
            mask_file = f"{frame_key}_{name}.npy"
            np.save(out / mask_file, mask)
            frame_ann[name] = {
                "mask_file": mask_file,
                "bboxes": masks_to_bboxes(mask),
            }
        if frame_ann:
            ann[frame_key] = frame_ann
    (out / "ann.json").write_text(json.dumps(ann, indent=2))
    print(f"wrote {len(ann)} annotated frames to {out / 'ann.json'}")
    return ann


if __name__ == "__main__":
    main()

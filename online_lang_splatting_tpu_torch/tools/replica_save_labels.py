"""Labelme-style GT annotations from Replica semantic renderings (port
of eval/replica_save_labels.py), without OpenCV.

Reads the vMAP-layout semantic_config.yaml (id -> class name) and the
semantic_class_*.png label images (through the port's decoder), selects
the scene's most frequent classes, and writes one labelme JSON per frame
({"info": {...}, "objects": [{category, segmentation, bbox, area}, ...]}):
each class's outer contours (eval/contours.py, as OpenCV's RETR_EXTERNAL /
CHAIN_APPROX_SIMPLE) with their bounding boxes and areas. The LERF
evaluation reads these folders (`eval.lerf_eval.load_annotations`).

    python -m online_lang_splatting_tpu_torch.tools.replica_save_labels \
        --semantic-config <scene>/imap/00/semantic_config.yaml \
        --frames 5,20,120 --out labels/room0_labelme
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import Counter
from pathlib import Path

import numpy as np

from ..eval.contours import bounding_rect, contour_area, find_external_contours
from ..eval.polygon import fill_poly
from ..utils.png import read_png

# Reference background semantic ids (replica_save_labels.py:10).
BACKGROUND_CLS = [126, 0, 95]


def load_labels(seg_file: str) -> dict[int, str]:
    """semantic_config.yaml → {id: name} (replica_save_labels.py:71-81)."""
    import yaml

    with open(seg_file) as f:
        cfg = yaml.safe_load(f)
    return {int(item["id"]): item["name"] for item in cfg["classes"]}


def read_gray8(path) -> np.ndarray:
    """A one-channel PNG as 8-bit grey, as OpenCV's IMREAD_GRAYSCALE
    reads it: 16-bit samples keep their high byte."""
    seg = read_png(path)
    if seg.ndim != 2:
        raise ValueError(f"{path}: a semantic label PNG must have one channel")
    return (seg >> 8).astype(np.uint8) if seg.dtype.itemsize == 2 else seg


def get_segmentation_mask(seg_label: np.ndarray):
    masks = []
    for sem_id in np.unique(seg_label):
        if sem_id == 0 or sem_id in BACKGROUND_CLS:
            continue
        masks.append((int(sem_id), seg_label == sem_id))
    return masks


def create_labelme_annotation(seg_label: np.ndarray, id_to_name: dict,
                              user_label_ids=None) -> list[dict]:
    """Per-class contour polygons + bboxes (replica_save_labels.py:32-57)."""
    annotations = []
    for sem_id, mask in get_segmentation_mask(seg_label):
        if user_label_ids is not None and sem_id not in user_label_ids:
            continue
        for contour in find_external_contours(mask.astype(np.uint8)):
            segmentation = contour.tolist()
            x, y, w, h = bounding_rect(contour)
            annotations.append({
                "category": id_to_name[sem_id],
                "group": 1,
                "segmentation": [segmentation],
                "area": contour_area(contour),
                "bbox": [x, y, x + w, y + h],
                "iscrowd": 0,
                "note": "",
            })
    return annotations


def save_annotations_to_json(info: dict, annotations: list, json_file):
    Path(json_file).parent.mkdir(parents=True, exist_ok=True)
    with open(json_file, "w") as f:
        json.dump({"info": info, "objects": annotations}, f, indent=4)


def get_top_labels(seg_file: str, label_folder: str, top_num: int = 10):
    """Most common classes over every 10th frame
    (replica_save_labels.py:83-110)."""
    id_to_name = load_labels(seg_file)
    counter: Counter = Counter()
    paths = sorted(glob.glob(os.path.join(label_folder, "semantic*.png")))[::10]
    for p in paths:
        seg = read_gray8(p)
        counter.update(np.unique(seg).tolist())
    out = []
    for label_id, _count in counter.most_common(top_num):
        if label_id in BACKGROUND_CLS:
            continue
        out.append((int(label_id), id_to_name.get(int(label_id), "Unknown")))
    return out


def save_json_labels(seg_file, seg_label, output_json, img_name, img_idx,
                     user_label_names=None) -> bool:
    id_to_name = load_labels(seg_file)
    user_label_ids = None
    if user_label_names is not None:
        user_label_ids = [
            i for i, n in id_to_name.items() if n in user_label_names
        ]
    info = {
        "name": f"{img_name}_{img_idx}.jpg",
        "width": int(seg_label.shape[1]),
        "height": int(seg_label.shape[0]),
        "depth": 3,
        "note": "",
    }
    annotations = create_labelme_annotation(seg_label, id_to_name, user_label_ids)
    if not annotations:
        return False
    save_annotations_to_json(info, annotations, output_json)
    return True


def polygon_to_mask(img_shape, points_list) -> np.ndarray:
    """Rasterize labelme polygons (reference eval/utils.py:83-89)."""
    mask = np.zeros(img_shape, np.uint8)
    for pts in points_list:
        fill_poly(mask, [np.asarray(pts, np.int32)], 1)
    return mask


def stack_mask(mask_base: np.ndarray, mask_add: np.ndarray) -> np.ndarray:
    return np.logical_or(mask_base, mask_add).astype(mask_base.dtype)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--semantic-config", required=True)
    p.add_argument("--label-folder", default=None,
                   help="folder of semantic_class_*.png (default: sibling "
                        "semantic_class/ of the config)")
    p.add_argument("--frames", required=True,
                   help="comma-separated frame indices to annotate")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--scene-name", default="frame")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    folder = args.label_folder or str(
        Path(args.semantic_config).parent / "semantic_class"
    )
    top = get_top_labels(args.semantic_config, folder, args.top_k)
    names = [n for _i, n in top]
    print("top classes:", names)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    written = 0
    for idx in (int(x) for x in args.frames.split(",")):
        f = Path(folder) / f"semantic_class_{idx}.png"
        if not f.exists():
            continue
        seg = read_png(f)
        ok = save_json_labels(
            args.semantic_config, seg,
            out / f"frame_{idx:05d}.json", args.scene_name, idx,
            user_label_names=names,
        )
        written += int(ok)
    print(f"wrote {written} labelme JSONs to {out}")
    return written


if __name__ == "__main__":
    main()

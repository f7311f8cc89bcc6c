"""LERF-protocol 2D evaluation: query IoU and localization accuracy (port
of eval/lerf_eval.py).

Rendered low-dim language maps are decoded to 768-d CLIP space (one-stage
AE decode, or the online 15 -> 32 decode then 32 -> 768), relevancy is
computed per query, smoothed with a 30x30 box blur and blended 0.5,
normalized, thresholded, mode-filtered and scored as IoU against the GT
masks; localization checks whether the smoothed relevancy's argmax lands
in a GT box. Everything after loading a map runs on the relevancy's
device: decode and relevancy in chunks, so a 1200x680x768 CLIP map is
never built, and the blur and mode filter as convolutions in place of the
JAX package's OpenCV calls (reflect-101 and zero borders as OpenCV uses).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .polygon import polygons_to_mask
from .relevancy import CLIPRelevancy, pairwise_relevancy


def box_blur(x: torch.Tensor, scale: int = 30) -> torch.Tensor:
    """cv2.filter2D with a uniform scale x scale kernel on an (H, W) map:
    anchor at scale // 2, reflect-101 border."""
    a = scale // 2
    padded = F.pad(x[None, None], (a, scale - 1 - a, a, scale - 1 - a), mode="reflect")
    kernel = torch.full((1, 1, scale, scale), 1.0 / (scale * scale),
                        dtype=x.dtype, device=x.device)
    return F.conv2d(padded, kernel)[0, 0]


def mode_smooth(mask: torch.Tensor, scale: int = 3) -> torch.Tensor:
    """Majority filter over (2 scale + 1)^2 neighbourhoods with a zero
    border: the count of set pixels is above half the window."""
    k = 2 * scale + 1
    ones = torch.ones((1, 1, k, k), dtype=torch.float32, device=mask.device)
    counts = F.conv2d(mask.to(torch.float32)[None, None], ones, padding=scale)[0, 0]
    return counts > (k * k) / 2


def _resize_mask(mask, w: int, h: int, device) -> torch.Tensor:
    """GT mask -> (h, w) bool on `device`. At another size, bilinear with
    half-pixel centres rounded to {0, 1} (cv2.resize INTER_LINEAR on a
    uint8 mask, up to its fixed-point rounding)."""
    m = torch.as_tensor(np.asarray(mask), device=device)
    if tuple(m.shape) == (h, w):
        return m.to(torch.bool)
    v = F.interpolate(m.to(torch.float32)[None, None], size=(h, w), mode="bilinear",
                      align_corners=False)[0, 0]
    return v >= 0.5


def activate_stream(sem_map, relevancy: CLIPRelevancy, img_ann: dict,
                    thresh: float = 0.5, valid_map: torch.Tensor | None = None):
    """sem_map (levels, H, W, 768) -> (per-query IoU list, chosen levels).
    `valid_map` (levels, prompts, H, W), if given, is used in place of the
    relevancy of `sem_map` (and is not modified)."""
    if valid_map is None:
        valid_map = relevancy.get_max_across(sem_map)
    valid = valid_map.clone()
    n_head, n_prompt, h, w = valid.shape
    chosen_iou, chosen_lvl = [], []
    for k in range(n_prompt):
        mask_gt = _resize_mask(img_ann[relevancy.positives[k]]["mask"], w, h, valid.device)
        iou_lvl = []
        for i in range(n_head):
            valid[i, k] = 0.5 * (box_blur(valid[i, k]) + valid[i, k])
            output = valid[i, k] - valid[i, k].min()
            output = output / (output.max() + 1e-9)
            output = torch.clamp(output * 2.0 - 1.0, 0, 1)
            mask_pred = mode_smooth(output > thresh)
            inter = int((mask_gt & mask_pred).sum())
            union = int((mask_gt | mask_pred).sum())
            iou_lvl.append(inter / max(union, 1))
        lvl = int(torch.argmax(valid[:, k].reshape(n_head, -1).amax(dim=1)))
        chosen_iou.append(iou_lvl[lvl])
        chosen_lvl.append(lvl)
    return chosen_iou, chosen_lvl


def lerf_localization(sem_map, relevancy: CLIPRelevancy, img_ann: dict,
                      valid_map: torch.Tensor | None = None) -> int:
    """Count queries whose smoothed-relevancy argmax lies in a GT box."""
    if valid_map is None:
        valid_map = relevancy.get_max_across(sem_map)
    n_head, n_prompt, h, w = valid_map.shape
    acc_num = 0
    positives = list(img_ann.keys())
    for k in range(n_prompt):
        avg = torch.stack([box_blur(valid_map[i, k]) for i in range(n_head)])
        head = int(torch.argmax(avg.reshape(n_head, -1).amax(dim=1)))
        m = avg[head]
        ys, xs = torch.nonzero(m == m.max(), as_tuple=True)
        # Boxes are in the annotation's pixel coordinates; the relevancy
        # map may be at another resolution.
        ann_h, ann_w = np.asarray(img_ann[positives[k]]["mask"]).shape[:2]
        sx, sy = w / max(ann_w, 1), h / max(ann_h, 1)
        for box in np.asarray(img_ann[positives[k]]["bboxes"]).reshape(-1, 4):
            x1, y1, x2, y2 = box[0] * sx, box[1] * sy, box[2] * sx, box[3] * sy
            inside = ((xs >= min(x1, x2)) & (xs <= max(x1, x2))
                      & (ys >= min(y1, y2)) & (ys <= max(y1, y2)))
            if bool(inside.any()):
                acc_num += 1
                break
    return acc_num


def make_fused_relevancy(decode_fn, block: int = 65536):
    """Low-dim code map -> CLIP decode -> all-prompt relevancy, in chunks
    of `block` rows on the relevancy's device, so the (H W, 768) CLIP map
    exists one chunk at a time. `decode_fn((B, code) tensor) -> (B, 768)`.
    Returns `fn(flat_codes (N, code), relevancy, h, w) -> (prompts, h, w)`."""

    @torch.no_grad()
    def fn(flat_codes, relevancy: CLIPRelevancy, h: int, w: int) -> torch.Tensor:
        flat = torch.as_tensor(flat_codes, dtype=torch.float32, device=relevancy.device)
        out = torch.cat([
            pairwise_relevancy(decode_fn(flat[i: i + block]), relevancy.pos_embeds,
                               relevancy.neg_embeds)
            for i in range(0, flat.shape[0], block)])
        return out.T.reshape(-1, h, w)

    return fn


@torch.no_grad()
def decode_lang_map(lang_map, extractor, online_ae=None, out_hw=None) -> torch.Tensor:
    """(L, H, W) rendered low-dim map -> (H', W', 768) CLIP-space map on
    the extractor's device. One-stage: AE decode 15 -> 768. Two-stage:
    online decode 15 -> 32, then AE decode 32 -> 768."""
    lang_map = torch.as_tensor(lang_map, dtype=torch.float32, device=extractor.device)
    l, h, w = lang_map.shape
    flat = lang_map.reshape(l, -1).T
    if online_ae is not None:
        flat = online_ae.decode(flat)
    out = extractor.decode_codes(flat).reshape(h, w, -1)
    if out_hw is not None and tuple(out_hw) != (h, w):
        out = F.interpolate(out.permute(2, 0, 1)[None], size=tuple(out_hw),
                            mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    return out


def load_annotations(ann_path) -> dict:
    """GT annotations from either supported format: the consolidated
    `ann.json` ({frame: {label: {mask_file | mask, bboxes}}}) or a folder
    of labelme-style `frame_XXXXX.json` files with polygon segmentations.
    Returns {frame_key: {label: {"mask": bool (H, W), "bboxes": (N, 4)}}}."""
    ann_path = Path(ann_path)
    if ann_path.is_dir():
        anns: dict = {}
        for js in sorted(ann_path.glob("*.json")):
            data = json.loads(js.read_text())
            if "objects" not in data:
                continue
            h, w = data["info"]["height"], data["info"]["width"]
            idx = int(data["info"]["name"].split("_")[-1].split(".")[0])
            frame: dict = {}
            for obj in data["objects"]:
                label = obj["category"]
                mask = polygons_to_mask((h, w), obj["segmentation"])
                box = np.asarray(obj["bbox"], np.float32).reshape(-1, 4)
                if label in frame:
                    frame[label]["mask"] = np.logical_or(frame[label]["mask"], mask)
                    frame[label]["bboxes"] = np.concatenate([frame[label]["bboxes"], box])
                else:
                    frame[label] = {"mask": mask.astype(bool), "bboxes": box}
            anns[f"{idx:05d}"] = frame
        return anns
    anns = json.loads(ann_path.read_text())
    for frame_ann in anns.values():
        for q in frame_ann.values():
            if "mask_file" in q and "mask" not in q:
                q["mask"] = np.load(ann_path.parent / q["mask_file"])
            q["mask"] = np.asarray(q["mask"])
            q["bboxes"] = np.asarray(q["bboxes"])
    return anns


def _scene_result(iou_all, acc, total, distinct, frames_scored) -> dict:
    return {
        "miou": float(np.mean(iou_all)) if iou_all else float("nan"),
        "localization_acc": acc / max(total, 1),
        "num_queries": total,
        "distinct_queries": len(distinct),
        "frames_scored": frames_scored,
    }


def evaluate_scene(lang_dir: str, ann_path: str, extractor, relevancy: CLIPRelevancy,
                   online_ae=None, eval_size=(480, 640), mask_thresh: float = 0.5):
    """Scene-level mIoU / localization accuracy over annotated frames.
    lang_dir holds rendered {idx}.npy (L, H, W) maps."""
    lang_dir = Path(lang_dir)
    anns = load_annotations(ann_path)
    iou_all, acc, total = [], 0, 0
    distinct, frames_scored = set(), 0

    def _decode(flat):
        z = online_ae.decode(flat) if online_ae is not None else flat
        return extractor.decode_codes(z)

    fused = make_fused_relevancy(_decode)
    for frame_name, img_ann in anns.items():
        f = lang_dir / f"{frame_name}.npy"
        if not f.exists():
            continue
        lang_map = np.load(f)
        relevancy.set_positives(list(img_ann.keys()))
        l, h, w = lang_map.shape
        if (h, w) == tuple(eval_size):
            valid = fused(lang_map.reshape(l, -1).T, relevancy, h, w)[None]
        else:
            # eval_size differs from the map: the protocol resizes the
            # DECODED 768-d map (bilinear in CLIP space).
            clip_map = decode_lang_map(lang_map, extractor, online_ae, eval_size)
            valid = relevancy.get_max_across(clip_map[None])
        ious, _ = activate_stream(None, relevancy, img_ann, mask_thresh, valid_map=valid)
        iou_all.extend(ious)
        acc += lerf_localization(None, relevancy, img_ann, valid_map=valid)
        total += len(img_ann)
        distinct.update(img_ann.keys())
        frames_scored += 1
    return _scene_result(iou_all, acc, total, distinct, frames_scored)


def evaluate_scene_multilevel(feat_dirs, ann_path: str, decode_fn,
                              relevancy: CLIPRelevancy, eval_size=(480, 640),
                              mask_thresh: float = 0.4, hwc: bool = True):
    """LangSplat-protocol eval: one rendered-feature dir per level. Each
    frame's code maps are resized to `eval_size` (before decoding, as
    that protocol does), decoded with `decode_fn((HW, code) -> (HW, 768))`
    and scored with the shared relevancy protocol; `hwc` selects
    LangSplat's (H, W, C) .npy layout over this repository's (C, H, W)."""
    anns = load_annotations(ann_path)
    feat_dirs = [Path(d) for d in feat_dirs]
    h, w = eval_size
    iou_all, acc, total = [], 0, 0
    distinct, frames_scored = set(), 0
    fused = make_fused_relevancy(decode_fn)
    for frame_name, img_ann in anns.items():
        relevancy.set_positives(list(img_ann.keys()))
        levels = []
        for d in feat_dirs:
            f = d / f"{frame_name}.npy"
            if not f.exists():
                f = d / f"{int(frame_name)}.npy"
            if not f.exists():
                break
            arr = torch.as_tensor(np.load(f), dtype=torch.float32, device=relevancy.device)
            if hwc:
                arr = arr.permute(2, 0, 1)
            if tuple(arr.shape[1:]) != (h, w):
                arr = F.interpolate(arr[None], size=(h, w), mode="bilinear",
                                    align_corners=False)[0]
            levels.append(fused(arr.reshape(arr.shape[0], -1).T, relevancy, h, w))
        if len(levels) != len(feat_dirs):
            continue
        valid = torch.stack(levels)  # (levels, prompts, H, W)
        ious, _ = activate_stream(None, relevancy, img_ann, mask_thresh, valid_map=valid)
        iou_all.extend(ious)
        acc += lerf_localization(None, relevancy, img_ann, valid_map=valid)
        total += len(img_ann)
        distinct.update(img_ann.keys())
        frames_scored += 1
    return _scene_result(iou_all, acc, total, distinct, frames_scored)

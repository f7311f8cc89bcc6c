"""3D semantic evaluation: per-class Chamfer and EMD against a ground-truth
point cloud (port of tsdf-fusion/evaluation_3d.py).

Each point's 15-d code is decoded to the 768-d CLIP space (through the
online decoder first in the two-stage pipeline) and classified by the
argmax over the class text embeddings; for every class with at least 10
points on both sides, the Chamfer distance and the approximate EMD (each
side subsampled to `--max-points` by numpy's `default_rng(0)`, as the JAX
package draws them) are computed between the predicted and the ground-truth
class clouds on the device. `evaluate_3d` is the core, for callers with
their own decoder and relevancy.

    python -m online_lang_splatting_tpu_torch.tools.evaluation_3d \
        --pred semantic_pc.ply --gt gt_pc.ply --classes "wall,floor,chair" \
        --weights-dir <npz dir> [--online-ae online_ae.npz] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

DECODE_BLOCK = 65536  # points decoded and classified at a time


@torch.no_grad()
def classify(codes, decode, relevancy, with_negatives: bool = False) -> np.ndarray:
    """(N, code) -> (N,) class indices by the semantic argmax (-1: a
    negative won), `DECODE_BLOCK` points at a time."""
    codes = torch.as_tensor(codes, dtype=torch.float32, device=relevancy.device)
    labels = [relevancy.get_semantic_map(decode(codes[i: i + DECODE_BLOCK])[None, None],
                                         with_negatives=with_negatives).reshape(-1)
              for i in range(0, codes.shape[0], DECODE_BLOCK)]
    return torch.cat(labels).cpu().numpy() if labels else np.zeros(0, np.int64)


def evaluate_3d(pts, codes, decode, relevancy, gt_pts, gt_labels, classes, *,
                with_negatives: bool = False, max_points: int = 4096, labels=None) -> dict:
    """Per-class Chamfer and EMD of the predicted cloud (`pts` with `codes`,
    classified through `decode` and `relevancy`, or `labels` when given)
    against `gt_pts` with `gt_labels`. Returns the CLI's summary:
    {per_class: {name: {chamfer, emd, n_pred, n_gt}}, mean_chamfer,
    mean_emd}."""
    from ..ops.chamfer import chamfer_distance
    from ..ops.emd import earth_mover_distance

    device = relevancy.device
    if labels is None:
        relevancy.set_semantics(list(classes))
        labels = classify(codes, decode, relevancy, with_negatives)
    rng = np.random.default_rng(0)
    results = {}
    for ci, cname in enumerate(classes):
        pm = labels == ci
        gm = gt_labels == ci
        if pm.sum() < 10 or gm.sum() < 10:
            continue
        a, b = pts[pm], gt_pts[gm]
        cd = chamfer_distance(torch.as_tensor(a, device=device), torch.as_tensor(b, device=device))

        def sub(x):
            if len(x) > max_points:
                x = x[rng.choice(len(x), max_points, replace=False)]
            return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

        emd = float(earth_mover_distance(sub(a), sub(b)))
        results[cname] = {"chamfer": cd["chamfer"], "emd": emd,
                          "n_pred": int(pm.sum()), "n_gt": int(gm.sum())}
        print(f"{cname}: chamfer {cd['chamfer']:.4f} emd {emd:.4f}")
    return {
        "per_class": results,
        "mean_chamfer": float(np.mean([r["chamfer"] for r in results.values()]))
        if results else float("nan"),
        "mean_emd": float(np.mean([r["emd"] for r in results.values()]))
        if results else float("nan"),
    }


def load_online_ae(path, device):
    """The online 15 -> 32 codec (an OnlineAETrainer) from an npz tree."""
    from ..convert import online_ae_from_numpy
    from ..models.checkpoints import OnlineAETrainer, load_npz_tree

    online_ae = OnlineAETrainer(device=device)
    online_ae.model.load_state_dict(online_ae_from_numpy(load_npz_tree(path)["params"]))
    return online_ae


def load_decoder(weights_dir, online_ae_path, device):
    """decode fn (N, code) -> (N, 768) from a weights directory: the
    one-stage AE decoder without `online_ae_path`, else the online 15 -> 32
    decoder from that npz, then the 32 -> 768 AE decoder."""
    from ..models.checkpoints import load_extractor_from_dir

    single = online_ae_path is None
    extractor, _ = load_extractor_from_dir(weights_dir, {"language": {"single_stage": single}},
                                           device=device)
    if single:
        return extractor.decode_codes
    online_ae = load_online_ae(online_ae_path, device)
    return lambda z: extractor.decode_codes(online_ae.decode(z))


def load_relevancy(weights_dir, device):
    """CLIPRelevancy over the text tower of `weights_dir/clip_text.npz`."""
    from ..eval.relevancy import CLIPRelevancy
    from ..models.checkpoints import load_text_tower
    from ..models.tokenizer import SimpleTokenizer

    return CLIPRelevancy(load_text_tower(Path(weights_dir) / "clip_text.npz", device),
                         SimpleTokenizer(), device=device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pred", required=True, help="semantic_pc.ply (15-d codes)")
    p.add_argument("--gt", required=True, help="GT ply with x,y,z,label int columns")
    p.add_argument("--classes", required=True, help="comma-separated labels")
    p.add_argument("--weights-dir", required=True)
    p.add_argument("--online-ae", default=None)
    p.add_argument("--max-points", type=int, default=4096, help="per-class subsample for EMD")
    p.add_argument("--with-negatives", action="store_true",
                   help="append LERF negatives to the semantic argmax "
                        "(the LangSplat 3D-eval protocol)")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import entry_device
    from ..utils.ply import read_ply

    device = entry_device(args.device)
    classes = [c.strip() for c in args.classes.split(",")]
    decode = load_decoder(args.weights_dir, args.online_ae, device)
    relevancy = load_relevancy(args.weights_dir, device)

    pred = read_ply(args.pred)
    pts = np.stack([pred["x"], pred["y"], pred["z"]], -1)
    # Channels in numeric order (f_0, f_1, .., f_14): a name sort would put
    # f_10 .. f_14 before f_2, as the JAX package's CLI does (ROADMAP).
    codes = np.stack([pred[k] for k in sorted((k for k in pred if k.startswith("f_")),
                                              key=lambda k: int(k[2:]))], -1)
    gt = read_ply(args.gt)
    gt_pts = np.stack([gt["x"], gt["y"], gt["z"]], -1)

    summary = evaluate_3d(pts, codes, decode, relevancy, gt_pts, gt["label"], classes,
                          with_negatives=args.with_negatives, max_points=args.max_points)
    print(json.dumps(summary["per_class"], indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()

"""PCA compression baseline, round trip and query heatmaps (port of
language/autoencoder/pca/test_pca.py).

Loads a trained PCA model, compresses and reconstructs saved 768-d
feature maps, reports the mean squared error and the cosine, and with
`--query` and a weights directory holding clip_text.npz saves turbo
relevancy heatmaps of the query on the reconstructed features.

    python -m online_lang_splatting_tpu_torch.tools.test_pca \
        --model pca_model_23.npz --features <dir> \
        [--query vase --weights-dir <npz dir>] --out out/ [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
from pathlib import Path

import numpy as np


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--query", default=None)
    p.add_argument("--weights-dir", default=None,
                   help="converted clip_text.npz dir (for --query heatmaps)")
    p.add_argument("--out", default="pca_eval")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import entry_device

    device = entry_device(args.device)
    model = np.load(args.model)
    mean, components = model["mean"], model["components"]

    text_emb = None
    if args.query and args.weights_dir:
        from ..eval.relevancy import CLIPRelevancy
        from ..models.checkpoints import load_text_tower
        from ..models.tokenizer import SimpleTokenizer

        rel = CLIPRelevancy(load_text_tower(Path(args.weights_dir) / "clip_text.npz", device),
                            SimpleTokenizer(), device=device)
        text_emb = rel._encode([args.query])[0].cpu().numpy()
        text_emb = text_emb / np.linalg.norm(text_emb)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    files = sorted(glob.glob(os.path.join(args.features, "*.npy")))[:: args.every]
    mses, coss = [], []
    for f in files:
        fm = np.load(f).astype(np.float32)
        c, h, w = fm.shape if fm.ndim == 3 else (fm.shape[1], 0, 0)
        flat = fm.reshape(c, -1).T if fm.ndim == 3 else fm
        z = (flat - mean) @ components.T
        rec = z @ components + mean
        mses.append(float(np.mean((rec - flat) ** 2)))
        denom = np.linalg.norm(rec, axis=-1) * np.linalg.norm(flat, axis=-1) + 1e-9
        coss.append(float(np.mean(np.sum(rec * flat, -1) / denom)))
        print(f"{Path(f).name}: mse {mses[-1]:.5f} cos {coss[-1]:.4f}")
        if text_emb is not None and h:
            from ..eval.colormaps import ColormapOptions, colormap_saving

            sim = rec / (np.linalg.norm(rec, axis=-1, keepdims=True) + 1e-9)
            sim = (sim @ text_emb).reshape(h, w)
            sim = (sim - sim.min()) / max(sim.max() - sim.min(), 1e-9)
            colormap_saving(sim, ColormapOptions("turbo"), out / f"{Path(f).stem}_heatmap.png")
    print(f"\nmean mse {np.mean(mses):.5f}  mean cos {np.mean(coss):.4f} "
          f"over {len(files)} files")
    return {"mean_mse": float(np.mean(mses)), "mean_cos": float(np.mean(coss)),
            "files": len(files)}


if __name__ == "__main__":
    main()

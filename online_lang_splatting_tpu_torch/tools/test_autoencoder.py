"""Autoencoder round trip of saved feature labels (port of
language/test_autoencoder.py).

Loads an autoencoder checkpoint, pushes 768-d CLIP feature labels
(`*_f.npy`, (768, H, W) or flat (N, 768)) through encode -> decode, and
reports the mean squared L2 and the cosine per file and over all; with
`--online-ae` the codes also round-trip the online 32 <-> 15 codec
(two-stage). `--viz` writes original | reconstruction PCA pictures.

    python -m online_lang_splatting_tpu_torch.tools.test_autoencoder \
        --weights-dir <npz dir> --features labels/ [--online-ae online_ae.npz] \
        [--viz out/] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np
import torch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--weights-dir", required=True,
                   help="directory with autoencoder.npz (convert_weights.py)")
    p.add_argument("--features", required=True,
                   help="directory of 768-d feature .npy labels")
    p.add_argument("--online-ae", default=None,
                   help="two-stage: online 32<->15 codec npz")
    p.add_argument("--limit", type=int, default=16)
    p.add_argument("--viz", default=None,
                   help="write original/reconstructed PCA PNGs here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import entry_device
    from ..convert import language_from_numpy
    from ..models.checkpoints import OnlineAETrainer, load_extractor_from_dir, load_npz_tree

    device = entry_device(args.device)
    single_stage = args.online_ae is None
    extractor, _ = load_extractor_from_dir(
        args.weights_dir, {"language": {"single_stage": single_stage}}, device=device)
    online = None
    if args.online_ae:
        online = OnlineAETrainer(device=device)
        online.model.load_state_dict(language_from_numpy(
            online_ae=load_npz_tree(args.online_ae)["params"])["online_ae"])

    files = sorted(glob.glob(str(Path(args.features) / "*.npy")))[: args.limit]
    if not files:
        raise FileNotFoundError(f"no .npy under {args.features}")

    @torch.no_grad()
    def roundtrip(flat768):
        codes = extractor.ae.encode(torch.as_tensor(flat768, device=device))
        if online is not None:
            # Two-stage: 768 -> 32 offline, 32 -> 15 -> 32 online, 32 -> 768.
            codes = online.decode(online.model.encode(codes))
        return extractor.decode_codes(codes).cpu().numpy()

    l2s, coss = [], []
    for f in files:
        arr = np.load(f).astype(np.float32)
        if arr.ndim == 3:  # (768, H, W)
            c, h, w = arr.shape
            flat = np.ascontiguousarray(arr.reshape(c, -1).T)
        else:
            flat = arr
            h = w = None
        rec = roundtrip(flat)
        l2 = float(np.mean(np.sum((rec - flat) ** 2, -1)))
        denom = np.linalg.norm(rec, axis=-1) * np.linalg.norm(flat, axis=-1) + 1e-9
        cos = float(np.mean(np.sum(rec * flat, -1) / denom))
        l2s.append(l2)
        coss.append(cos)
        print(f"{Path(f).name}: l2 {l2:.5f}  cos {cos:.4f}")
        if args.viz and h is not None:
            from ..eval.colormaps import apply_pca_colormap
            from ..utils.png import write_png

            out = Path(args.viz)
            out.mkdir(parents=True, exist_ok=True)
            both = np.concatenate([apply_pca_colormap(flat.reshape(h, w, -1)),
                                   apply_pca_colormap(rec.reshape(h, w, -1))], axis=1)
            write_png(out / f"{Path(f).stem}_roundtrip.png", (both * 255).astype(np.uint8))

    print(f"\nmean l2 {np.mean(l2s):.5f}  mean cos {np.mean(coss):.4f} "
          f"over {len(files)} files")
    return {"mean_l2": float(np.mean(l2s)), "mean_cos": float(np.mean(coss))}


if __name__ == "__main__":
    main()

"""PCA compression baseline, training (port of
language/autoencoder/pca/train_pca.py).

Fits an n-component PCA (default 23) on saved 768-d CLIP feature labels
with the port's streaming `IncrementalPCA` (float64 on the host; the
reference's sklearn model replaced as in the JAX package) and saves mean,
components and n_components in an npz.

    python -m online_lang_splatting_tpu_torch.tools.train_pca \
        --feat-dirs dirA dirB --every 9 --components 23 --out pca_model_23.npz
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feat-dirs", nargs="+", required=True)
    p.add_argument("--every", type=int, default=9,
                   help="use every Nth feature file (reference default)")
    p.add_argument("--components", type=int, default=23)
    p.add_argument("--out", default="pca_model_23.npz")
    p.add_argument("--device", default="cuda",
                   help="checked like every entry point's; the fit runs on the host")
    args = p.parse_args(argv)

    from .. import entry_device
    from ..models.autoencoder import IncrementalPCA

    entry_device(args.device)
    files = []
    for d in args.feat_dirs:
        lst = sorted(glob.glob(os.path.join(d, "*.npy")))[:: args.every]
        files.extend(lst)
        print(f"{d}: {len(lst)} files")
    if not files:
        raise FileNotFoundError("no feature files found")

    pca = IncrementalPCA(n_components=args.components)
    for i, f in enumerate(files):
        fm = np.load(f)  # (768, H, W) or (N, 768)
        feats = fm.reshape(fm.shape[0], -1).T if fm.ndim == 3 else fm
        pca.partial_fit(feats.astype(np.float32))
        if i % 10 == 0:
            print(f"fitted {i + 1}/{len(files)}")

    np.savez(args.out, mean=np.asarray(pca.mean), components=np.asarray(pca.components),
             n_components=args.components)
    print(f"saved PCA model to {args.out}")
    return {"files": len(files), "out": args.out}


if __name__ == "__main__":
    main()

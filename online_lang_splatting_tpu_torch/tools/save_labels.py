"""768-d dense CLIP feature labels for a folder of images (port of
language/save_labels.py).

Runs the dense encoder and the HR head over every Nth image and saves
`<stem>_f.npy` feature maps ((768, 192, 192)) for offline autoencoder
training, with optional PCA pictures. Images are read by the port's frame
decoder (PNG or JPEG).

    python -m online_lang_splatting_tpu_torch.tools.save_labels \
        --input-dir imgs/ --output-dir labels/ --weights-dir <npz dir> \
        [--every 1] [--visualize] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import time
from pathlib import Path

import numpy as np
import torch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--every", type=int, default=1)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import entry_device
    from ..models.checkpoints import load_extractor_from_dir
    from ..utils.png import read_rgb8, write_png
    from .language_features import pca_colormap

    device = entry_device(args.device)
    extractor, _ = load_extractor_from_dir(
        args.weights_dir, {"language": {"single_stage": True}}, device=device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    paths = sorted(
        glob.glob(f"{args.input_dir}/*.png") + glob.glob(f"{args.input_dir}/*.jpg")
    )[:: args.every]
    files, ms = [], []
    for i, path in enumerate(paths):
        img = read_rgb8(path).astype(np.float32)
        t0 = time.perf_counter()
        feat = extractor.hr_features(img)  # (192, 192, 768)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        feat = feat.cpu().numpy()
        stem = Path(path).stem
        np.save(out_dir / f"{stem}_f.npy", feat.transpose(2, 0, 1))
        files.append(str(out_dir / f"{stem}_f.npy"))
        if args.visualize:
            write_png(out_dir / f"{stem}_pca.png", (pca_colormap(feat) * 255).astype(np.uint8))
        if i % 20 == 0:
            print(f"{i + 1}/{len(paths)}")
    print(f"wrote {len(paths)} labels to {out_dir}")
    return {"files": files, "ms": ms}


if __name__ == "__main__":
    main()

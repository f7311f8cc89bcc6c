"""Dense language features of one image: the demo (port of
language/language_features.py).

Loads the fused extractor (ConvNeXt-L dense CLIP -> HR head), extracts the
(192, 192, 768) feature map of the image, prints the first call's and the
steady-state time, saves the map as `<stem>_f.npy` ((768, 192, 192)), and
renders a PCA picture and a text-query relevancy heatmap through the CLIP
text tower (a seeded random tower where no clip_text.npz is given). The
image is read by the port's frame decoder (PNG or JPEG).

    python -m online_lang_splatting_tpu_torch.tools.language_features \
        --high-res-model <hr_net.npz> --lang-model <weights_dir> \
        --input sample/demo_room.jpg --query-text vase \
        [--output-dir out] [--no-visualize] [--bf16] [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def pca_colormap(feat: np.ndarray) -> np.ndarray:
    """(H, W, C) features -> (H, W, 3) PCA projection in [0, 1]."""
    from ..eval.colormaps import apply_pca_colormap

    return apply_pca_colormap(feat)


def _timed(fn, device):
    """fn() and its wall time in ms, the device's queue drained."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Language Feature Visualization Tool")
    p.add_argument("--high-res-model", type=str, default=None,
                   help="converted hr_net.npz (or a weights dir)")
    p.add_argument("--lang-model", type=str, default=None,
                   help="directory of converted npz weights")
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--query-text", type=str, default="teddybear")
    p.add_argument("--no-visualize", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv towers (the autoencoder stays float32)")
    args = p.parse_args(argv)

    from .. import entry_device
    from ..convert import language_from_numpy
    from ..models.checkpoints import load_npz_tree
    from ..models.sed import LangFeatureExtractor
    from ..utils.png import read_rgb8, write_png

    device = entry_device(args.device)
    weights_dir = args.lang_model
    trees = {}
    if weights_dir and Path(weights_dir).is_dir():
        d = Path(weights_dir)
        for key, name in (("visual", "clip_visual"), ("ae", "autoencoder")):
            if (d / f"{name}.npz").exists():
                trees[key] = load_npz_tree(d / f"{name}.npz")
    if args.high_res_model and Path(args.high_res_model).exists():
        hr_path = Path(args.high_res_model)
        if hr_path.is_dir():
            hr_path = hr_path / "hr_net.npz"
        trees["hr"] = load_npz_tree(hr_path)
    if "visual" not in trees:
        print("[language_features] no converted weights; using random init "
              "(feature maps will be untrained)")
    states = language_from_numpy(**trees)
    extractor = LangFeatureExtractor(
        states.get("visual"), states.get("hr"), states.get("ae"),
        compute_dtype=torch.bfloat16 if args.bf16 else None, device=device)

    img = read_rgb8(args.input).astype(np.float32)
    hr_feat, first_ms = _timed(lambda: extractor.hr_features(img), device)
    print(f"Extracted {tuple(hr_feat.shape)} features in {first_ms:.1f} ms (first call)")
    hr_feat, steady_ms = _timed(lambda: extractor.hr_features(img), device)
    print(f"Steady-state: {steady_ms:.1f} ms ({1e3 / steady_ms:.1f} FPS)")

    out_dir = Path(args.output_dir or Path(args.input).parent)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(args.input).stem
    feat = hr_feat.cpu().numpy()
    result = {"shape": list(feat.shape), "first_ms": first_ms, "steady_ms": steady_ms,
              "fps": 1e3 / steady_ms, "features": str(out_dir / f"{stem}_f.npy")}
    np.save(out_dir / f"{stem}_f.npy", feat.transpose(2, 0, 1))
    print(f"Saved features to {out_dir / f'{stem}_f.npy'}")

    if not args.no_visualize:
        pca = (pca_colormap(feat) * 255).astype(np.uint8)
        write_png(out_dir / f"{stem}_pca.png", pca)
        result["pca"] = str(out_dir / f"{stem}_pca.png")
        print(f"Saved PCA visualization to {result['pca']}")

        # Text-query heatmap (text tower weights + the BPE vocabulary).
        from ..eval.relevancy import CLIPRelevancy
        from ..models.checkpoints import load_text_tower
        from ..models.init import make_generator
        from ..models.text_tower import TextTower
        from ..models.tokenizer import SimpleTokenizer

        text_path = weights_dir and Path(weights_dir) / "clip_text.npz"
        try:
            if text_path and text_path.exists():
                tower = load_text_tower(text_path, device)
            else:
                # A bare checkout: a seeded random text tower keeps the whole
                # pipeline (tokenize -> encode -> relevancy -> heatmap)
                # running; the heatmap is noise until real weights are given.
                print("No clip_text.npz — heatmap uses a random-init text tower (untrained)")
                tower = TextTower(generator=make_generator(0)).to(device).eval()
            rel = CLIPRelevancy(tower, SimpleTokenizer(), device=device)
            rel.set_positives([args.query_text])
            feat_n = feat / np.maximum(np.linalg.norm(feat, axis=-1, keepdims=True), 1e-9)
            relev = rel.get_max_across(feat_n[None])[0, 0].cpu().numpy()
            heat = (relev - relev.min()) / (np.ptp(relev) + 1e-9)
            heat_path = out_dir / f"{stem}_heatmap_{args.query_text}.png"
            write_png(heat_path, (heat * 255).astype(np.uint8))
            result["heatmap"] = str(heat_path)
            print(f"Saved '{args.query_text}' heatmap")
        except FileNotFoundError as e:
            print(f"Skipping heatmap: {e}")
    return result


if __name__ == "__main__":
    main()

"""Offline language-autoencoder training (port of
language/autoencoder/train_encoder_light.py).

Loads (768, 192, 192) `*_f.npy` feature labels, resizes each to 24 x 24
(half-pixel bilinear, `F.interpolate(align_corners=False)`; the JAX
script's single `cv2.resize` of a 768-channel map fails, as OpenCV takes
at most 512 channels), and trains the MLP autoencoder with l2 + 0.001 (1 -
cos) under AdamW + warmup/cosine (`models/autoencoder.py`'s optax-exact
optimizer) on one device, with the JAX script's permutation
(`default_rng(0)`) and batch arithmetic. Saves the converter's npz tree
(`params/...`, `batch_stats/...`).

    python -m online_lang_splatting_tpu_torch.tools.train_encoder_light \
        --data-dir <dir with *_f.npy> --out ae.npz \
        [--encoder-dims 384,192,96,48,24,15] [--epochs 150] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import time

import numpy as np
import torch
import torch.nn.functional as F


def load_labels(data_dir: str, target: int = 24) -> np.ndarray:
    """Each label (768, H, W) -> (target^2, 768) vectors, stacked."""
    out = []
    for f in sorted(glob.glob(f"{data_dir}/*.npy")):
        feat = np.load(f)
        if feat.ndim != 3 or feat.shape[0] != 768:
            continue
        small = F.interpolate(torch.from_numpy(feat.astype(np.float32))[None],
                              size=(target, target), mode="bilinear", align_corners=False)[0]
        out.append(small.permute(1, 2, 0).reshape(-1, 768).numpy())
    if not out:
        raise FileNotFoundError(f"no (768,H,W) .npy labels in {data_dir}")
    return np.concatenate(out, axis=0).astype(np.float32)


def init_model(encoder_dims, decoder_dims, device):
    """The autoencoder at its seeded initial weights."""
    from ..models.autoencoder import AutoencoderMLP
    from ..models.init import make_generator

    return AutoencoderMLP(encoder_dims, decoder_dims, generator=make_generator(0)).to(device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--encoder-dims", default="384,192,96,48,24,15")
    p.add_argument("--decoder-dims", default="24,48,96,192,384,384,768")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import entry_device
    from ..convert import ae_to_numpy
    from ..models import autoencoder as AE
    from ..models.checkpoints import save_npz_tree

    device = entry_device(args.device)
    data = load_labels(args.data_dir)
    print(f"{len(data)} feature vectors")
    enc = tuple(int(x) for x in args.encoder_dims.split(","))
    dec = tuple(int(x) for x in args.decoder_dims.split(","))
    model = init_model(enc, dec, device)
    rng = np.random.default_rng(0)
    optimizer = AE.make_offline_optimizer(model, args.lr)

    bs = args.batch_size
    steps_per_epoch = max(len(data) // bs, 1)
    epoch_loss, epoch_s = [], []
    t0 = time.time()
    for epoch in range(args.epochs):
        te = time.perf_counter()
        perm = rng.permutation(len(data))
        losses = []
        for s in range(steps_per_epoch):
            batch = torch.as_tensor(data[perm[s * bs: (s + 1) * bs]], device=device)
            losses.append(float(AE.offline_train_step(model, optimizer, batch)))
        epoch_s.append(time.perf_counter() - te)
        epoch_loss.append(float(np.mean(losses)))
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            print(f"epoch {epoch}: loss {epoch_loss[-1]:.6f} ({time.time() - t0:.0f}s)")

    save_npz_tree(args.out, ae_to_numpy(model.state_dict()))
    print(f"saved {args.out}")
    return {"vectors": len(data), "loss": epoch_loss, "epoch_s": epoch_s, "out": args.out}


if __name__ == "__main__":
    main()

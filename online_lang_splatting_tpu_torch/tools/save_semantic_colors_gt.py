"""Colourise ground-truth semantic-class frames for the 3D evaluation
(port of tsdf-fusion/save_semantic_colors_gt.py).

Each class id gets a colour from `random.Random(seed)` (the same table as
the JAX package's); the table is saved as `color_code.npy` beside the
output directory (the 3D evaluation maps mesh colours back to classes with
it), and every `semantic_class_*.png` (8- or 16-bit grey, read unchanged)
becomes an RGB `semantic_color_*.png`.

    python -m online_lang_splatting_tpu_torch.tools.save_semantic_colors_gt \
        --semantic-class-dir <scene>/imap/00/semantic_class --out <dir>
"""

from __future__ import annotations

import argparse
import glob
import os
import random
from pathlib import Path

import numpy as np


def generate_random_colors(n: int, seed: int = 0) -> np.ndarray:
    rng = random.Random(seed)
    return np.array([[rng.randint(0, 255) for _ in range(3)] for _ in range(n)], np.uint8)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--semantic-class-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num-classes", type=int, default=225)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ..utils.png import read_png, write_png

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    colors = generate_random_colors(args.num_classes, args.seed)
    np.save(out.parent / "color_code.npy", colors)

    files = sorted(glob.glob(os.path.join(args.semantic_class_dir, "semantic_class_*.png")))
    for f in files:
        sem = read_png(f).astype(int)
        colored = colors[np.clip(sem, 0, args.num_classes - 1)]
        write_png(out / Path(f).name.replace("semantic_class", "semantic_color"), colored)
    print(f"colorized {len(files)} frames into {out}; "
          f"color code at {out.parent / 'color_code.npy'}")
    return {"frames": len(files), "color_code": str(out.parent / "color_code.npy")}


if __name__ == "__main__":
    main()

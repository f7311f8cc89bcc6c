"""Two builds of the blend kernels on the same inputs, on the card.

    python -m online_lang_splatting_tpu_torch.tools.blend_ab --other DIR \
        [--cases 15:15 32:15 32:0] [--gaussians 30000] [--seed 0]

DIR is another checkout of the repository (an earlier commit unpacked with
`git archive`, say). Its `online_lang_splatting_tpu_torch/csrc` is built
beside this tree's (both into this tree's build/torch_kernels/) with the
same flags, and both libraries run on the same random scene at 1200x680,
for each `tile:F_lang` case:

- the forward outputs (channels, final T, n_contrib, n_touched) compared
  bit for bit, this build against the other;
- the backward's per-Gaussian sums (d_table) compared normalized, this
  build against the other, and each build against itself: a build whose
  library has `blend_reduce` writes per-instance rows and sums them per
  Gaussian in a fixed order (two launches, the same bits every run); an
  older one sums into d_table with float atomics, whose order varies;
- each kernel alone timed back to back (CUDA events, 50 launches, turns
  this, other, other, this); the backward with its zero fill and, in the
  rows form, the reduce launch.

Prints the card's name and power limit, then one JSON line per case, and
returns the cases.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch


def _scene(n: int, seed: int, width: int, height: int, tile: int, dev):
    """Preprocessed random Gaussians in front of the camera."""
    from ..ops.raster import api, scenes

    rng = np.random.default_rng(seed)
    means = np.zeros((n, 3), np.float32)
    means[:, 0] = rng.uniform(-1.8, 1.8, n)
    means[:, 1] = rng.uniform(-1.0, 1.0, n)
    means[:, 2] = rng.uniform(2.0, 6.0, n)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    view, proj, tx, ty = scenes.make_camera(width, height, fx=600.0, fy=600.0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    settings = api.RasterSettings(image_height=height, image_width=width, tanfovx=tx,
                                  tanfovy=ty, sh_degree=0, tile=tile)
    with torch.no_grad():
        prep = api.project(t(means), t(rng.uniform(0.3, 0.95, n)),
                           t(rng.uniform(0.005, 0.03, (n, 3))), t(q), viewmatrix=t(view),
                           projmatrix=t(proj), settings=settings,
                           shs=t(rng.normal(size=(n, 1, 3)) * 0.3))
    return prep, t(rng.normal(size=(n, 60)) * 0.3)


def _device_ms(fn, runs: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / runs


def _norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


def compare(lib_a, lib_b, *, tile: int, f_lang: int, gaussians: int, seed: int,
            width: int = 1200, height: int = 680, dev="cuda") -> dict:
    from ..ops.raster import kernels, tiled

    prep, lang = _scene(gaussians, seed, width, height, tile, dev)
    geom, feat, binning = tiled.blend_inputs(prep, lang[:, :f_lang].contiguous(),
                                             width=width, height=height, tile=tile)
    c = feat.shape[1]
    args = (geom, feat, binning.s_gid, binning.starts, binning.tile_counts)
    kw = dict(channels=c, width=width, height=height, tile=tile)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g_feat = torch.randn((c, height, width), generator=gen, device=dev)
    g_t = torch.randn((height, width), generator=gen, device=dev)

    def forward(lib):
        out = (torch.empty((c, height, width), device=dev),
               torch.empty((height, width), device=dev),
               torch.empty((height, width), dtype=torch.int32, device=dev),
               torch.zeros(geom.shape[0], dtype=torch.int32, device=dev))
        kernels.launch_forward(*args, *out, stats=True, lib=lib, **kw)
        return out

    em = binning.emission
    p = geom.shape[0]
    buffers = {}

    def backward(lib, fo):
        """d_table of one build: rows + reduce, or the atomic form; the
        buffers are allocated once per build and filled here."""
        if lib not in buffers:
            rows = (torch.empty((int(binning.s_gid.numel()), kernels.ctas_per_tile(tile),
                                 6 + c), device=dev) if hasattr(lib, "blend_reduce") else None)
            buffers[lib] = (rows, torch.empty((p, 6 + c), device=dev))
        rows, d_table = buffers[lib]
        if rows is None:
            d_table.zero_()
            kernels.launch_backward(*args, g_feat, g_t, fo[0], fo[1], d_table, lib=lib, **kw)
        else:
            rows.zero_()
            kernels.launch_backward(*args, g_feat, g_t, fo[0], fo[1], rows, lib=lib, **kw)
            kernels.launch_reduce(rows, em.inst, em.start, em.count, d_table, channels=c,
                                  lib=lib)
        return d_table

    fa, fb = forward(lib_a), forward(lib_b)
    da = backward(lib_a, fa).clone()
    da2 = backward(lib_a, fa).clone()
    db = backward(lib_b, fa).clone()
    db2 = backward(lib_b, fa).clone()
    torch.cuda.synchronize()
    row = dict(tile=tile, f_lang=f_lang, channels=c, instances=int(binning.s_gid.numel()),
               this_rows_form=hasattr(lib_a, "blend_reduce"),
               other_rows_form=hasattr(lib_b, "blend_reduce"),
               forward_bit_equal={k: bool(torch.equal(x, y)) for k, x, y in zip(
                   ("feat_img", "final_t", "n_contrib", "n_touched"), fa, fb)},
               d_table_vs_other=_norm(da, db),
               this_bit_equal_to_itself=bool(torch.equal(da, da2)),
               this_vs_itself=_norm(da, da2),
               other_bit_equal_to_itself=bool(torch.equal(db, db2)),
               other_vs_itself=_norm(db, db2))
    bufs = forward(lib_a)
    times = {"fwd": [], "bwd": []}
    for lib in (lib_a, lib_b, lib_b, lib_a):
        times["fwd"].append(_device_ms(lambda: kernels.launch_forward(
            *args, *bufs, stats=True, lib=lib, **kw)))
        times["bwd"].append(_device_ms(lambda: backward(lib, fa)))
    for key, (a1, b1, b2, a2) in times.items():
        row[f"{key}_device_ms"] = {"this": (a1 + a2) / 2, "other": (b1 + b2) / 2,
                                   "turns": [a1, b1, b2, a2]}
    return row


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--other", required=True, help="root of the other checkout")
    p.add_argument("--cases", nargs="+", default=["15:15", "15:0", "32:15", "32:0"],
                   help="tile:F_lang pairs")
    p.add_argument("--gaussians", type=int, default=30000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ..ops.raster import kernels

    if not torch.cuda.is_available():
        raise SystemExit("blend_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    lib_a = kernels.library()
    lib_b, info = kernels.build_library(
        Path(args.other) / "online_lang_splatting_tpu_torch" / "csrc")
    print(f"this build {kernels.build_info['path']}; other build {info['path']} "
          f"({info['seconds']:.2f} s)")
    rows = []
    for case in args.cases:
        tile, f_lang = map(int, case.split(":"))
        row = dict(compare(lib_a, lib_b, tile=tile, f_lang=f_lang, gaussians=args.gaussians,
                           seed=args.seed), card=card)
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

"""Two builds of the blend kernels on the same inputs, on the card.

    python -m online_lang_splatting_tpu_torch.tools.blend_ab --other DIR \
        [--cases 15:15 32:15 32:0 32:15:0.002] [--gaussians 30000] \
        [--visible N] [--seed 0]

DIR is another checkout of the repository (an earlier commit unpacked with
`git archive`, say). Its `online_lang_splatting_tpu_torch/csrc` is built
beside this tree's (both into this tree's build/torch_kernels/) with the
same flags, bound by its own sources' signatures, and both libraries run
on the same seeded scene at 1200x680 for each `tile:F_lang[:large]` case.
The scene holds `--gaussians` Gaussians (scales 0.005-0.03), `--visible`
of them (default all) in front of the camera and the rest behind it (no
instance: zero rows of d_table, as most of a map's are in one view); a
share `large` of them, drawn at random, get scales of 0.05-0.3 and cover
tens to hundreds of tiles (the long instance lists of large splats).

- the forward outputs (channels, final T, n_contrib, n_touched) compared
  bit for bit, this build against the other;
- the backward's per-Gaussian sums (d_table) compared bit for bit and
  normalized, this build against the other, and each build against
  itself. This package's rows kernel flags the rows it stores in `stored`
  and leaves the rest unwritten, and its reduce reads only the flagged
  ones; an earlier rows form (no `stored`) needs its rows zeroed and reads
  them all, to the same bits; an older form still sums into d_table with
  float atomics, whose order varies (`takes_stored`, `_older_backward`);
- each kernel alone timed by replaying 50 launches captured in a CUDA
  graph (`utils.profiling.graph_ms`), in turns this, other, other, this:
  the forward, the backward (its fill of the flags or of the rows, the
  rows kernel and, in a rows form, the reduce), the reduce alone, and
  `index_add_` on this build's rows (its unstored rows zeroed), the
  library call that sums the same rows per Gaussian;
- the instance lists: Gaussians with an instance, the longest list, and
  the instances in lists over 32.

Prints the card's name and power limit, then one JSON line per case, and
returns the cases.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

RUNS = 50


def takes_stored(lib: ctypes.CDLL) -> bool:
    """Whether a library's backward records its stored rows in flags that
    its reduce reads (this package's ABI), rather than needing zeroed rows
    (an earlier checkout's, or its atomic form without a reduce)."""
    from ..ops.raster import kernels

    fn = getattr(lib, "blend_reduce", None)
    return fn is not None and len(fn.argtypes) == len(kernels.ARGTYPES["blend_reduce"])


def _older_backward(lib, geom, feat, s_gid, starts, tile_counts, g_feat, g_t, feat_img,
                    final_t, out, *, channels, width, height, tile):
    """An earlier checkout's backward, which takes no `stored`: per-instance
    rows into `out` (zeroed by the caller), or its atomic form's d_table."""
    err = lib.blend_bwd(
        geom.data_ptr(), feat.data_ptr(), s_gid.data_ptr(), starts.data_ptr(),
        tile_counts.data_ptr(), g_feat.data_ptr(), g_t.data_ptr(), feat_img.data_ptr(),
        final_t.data_ptr(), out.data_ptr(), channels, width, height, tile,
        torch.cuda.current_stream(feat.device).cuda_stream)
    if err:
        raise RuntimeError(f"the other build's blend_bwd failed: CUDA error {err}")


def _older_reduce(lib, rows, emission, d_table, *, channels):
    """An earlier checkout's reduce (no `stored`): all K rows of each
    instance, no flags and no s_gid."""
    err = lib.blend_reduce(
        rows.data_ptr(), emission.inst.data_ptr(), emission.start.data_ptr(),
        emission.count.data_ptr(), d_table.data_ptr(), channels, d_table.shape[0],
        rows.shape[1], torch.cuda.current_stream(rows.device).cuda_stream)
    if err:
        raise RuntimeError(f"the other build's blend_reduce failed: CUDA error {err}")


def _scene(n: int, seed: int, width: int, height: int, tile: int, dev, *,
           visible: int | None = None, large: float = 0.0):
    """Preprocessed seeded Gaussians and their 60 language channels."""
    from ..ops.raster import api, scenes

    rng = np.random.default_rng(seed)
    means = np.zeros((n, 3), np.float32)
    means[:, 0] = rng.uniform(-1.8, 1.8, n)
    means[:, 1] = rng.uniform(-1.0, 1.0, n)
    means[:, 2] = rng.uniform(2.0, 6.0, n)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opacity = rng.uniform(0.3, 0.95, n)
    scales = rng.uniform(0.005, 0.03, (n, 3))
    shs = rng.normal(size=(n, 1, 3)) * 0.3
    lang = rng.normal(size=(n, 60)) * 0.3
    # Drawn after the rest, so that the default scene stays as it was.
    if visible is not None and visible < n:
        means[rng.permutation(n)[visible:], 2] = -5.0
    if large > 0:
        big = rng.uniform(size=n) < large
        scales[big] = rng.uniform(0.05, 0.3, (int(big.sum()), 3))
    view, proj, tx, ty = scenes.make_camera(width, height, fx=600.0, fy=600.0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    settings = api.RasterSettings(image_height=height, image_width=width, tanfovx=tx,
                                  tanfovy=ty, sh_degree=0, tile=tile)
    with torch.no_grad():
        prep = api.project(t(means), t(opacity), t(scales), t(q), viewmatrix=t(view),
                           projmatrix=t(proj), settings=settings, shs=t(shs))
    return prep, t(lang)


def _norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


def compare(lib_a, lib_b, *, tile: int, f_lang: int, gaussians: int, seed: int,
            visible: int | None = None, large: float = 0.0, width: int = 1200,
            height: int = 680, dev="cuda") -> dict:
    """One case on the seeded scene (see the module's note)."""
    from ..ops.raster import tiled

    prep, lang = _scene(gaussians, seed, width, height, tile, dev, visible=visible,
                        large=large)
    geom, feat, binning = tiled.blend_inputs(prep, lang[:, :f_lang].contiguous(),
                                             width=width, height=height, tile=tile)
    return dict(f_lang=f_lang, visible=visible, large=large,
                **compare_inputs(lib_a, lib_b, geom, feat, binning, width=width,
                                 height=height, tile=tile, seed=seed))


def compare_inputs(lib_a, lib_b, geom, feat, binning, *, width: int, height: int,
                   tile: int, seed: int) -> dict:
    """Both builds on one render's blend inputs (C <= 64), the cotangents
    drawn from `seed`: the checks and times of the module's note."""
    from ..ops.raster import kernels
    from ..utils.profiling import graph_ms

    dev = feat.device
    c = feat.shape[1]
    args = (geom, feat, binning.s_gid, binning.starts, binning.tile_counts)
    kw = dict(channels=c, width=width, height=height, tile=tile)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g_feat = torch.randn((c, height, width), generator=gen, device=dev)
    g_t = torch.randn((height, width), generator=gen, device=dev)
    em = binning.emission
    p, s_count, k = geom.shape[0], int(binning.s_gid.numel()), kernels.ctas_per_tile(tile)

    def forward_buffers():
        return (torch.empty((c, height, width), device=dev),
                torch.empty((height, width), device=dev),
                torch.empty((height, width), dtype=torch.int32, device=dev),
                torch.zeros(p, dtype=torch.int32, device=dev))

    fo = forward_buffers()
    kernels.launch_forward(*args, *fo, stats=True, **kw)

    def build_steps(lib):
        """The fill, the rows kernel and the reduce of one build (the
        reduce None for an atomic form), on buffers allocated here."""
        rows_form, flags = hasattr(lib, "blend_reduce"), takes_stored(lib)
        table = torch.empty((p, 6 + c), device=dev)
        rows = torch.empty((s_count, k, 6 + c), device=dev) if rows_form else table
        stored = (torch.empty((s_count, kernels.flag_stride(k)), dtype=torch.uint8,
                              device=dev) if flags else None)

        def fill():
            (stored if flags else rows).zero_()

        def run_rows():
            if flags:
                kernels.launch_backward(*args, g_feat, g_t, fo[0], fo[1], rows, stored,
                                        lib=lib, **kw)
            else:
                _older_backward(lib, *args, g_feat, g_t, fo[0], fo[1], rows, **kw)

        def run_reduce():
            if flags:
                kernels.launch_reduce(rows, stored, binning.s_gid, em.inst, em.start,
                                      em.count, table, channels=c, lib=lib)
            else:
                _older_reduce(lib, rows, em, table, channels=c)

        def backward():
            fill()
            run_rows()
            if rows_form:
                run_reduce()

        return dict(table=table, rows=rows, stored=stored, backward=backward,
                    reduce=run_reduce if rows_form else None)

    steps = {"this": build_steps(lib_a), "other": build_steps(lib_b)}
    tables = {}
    for name, st in steps.items():
        st["backward"]()
        first = st["table"].clone()
        st["backward"]()
        tables[name] = (first, st["table"].clone())
    fb = forward_buffers()
    kernels.launch_forward(*args, *fb, stats=True, lib=lib_b, **kw)
    torch.cuda.synchronize()
    (da, da2), (db, db2) = tables["this"], tables["other"]
    count = em.count
    row = dict(tile=tile, channels=c, gaussians=p, instances=s_count, with_instances=int((count > 0).sum()),
               max_instances=int(count.max()), over_32=int((count > 32).sum()),
               instances_in_over_32=int(count[count > 32].sum()),
               this_rows_form=hasattr(lib_a, "blend_reduce"),
               other_rows_form=hasattr(lib_b, "blend_reduce"),
               forward_bit_equal={key: bool(torch.equal(x, y)) for key, x, y in zip(
                   ("feat_img", "final_t", "n_contrib", "n_touched"), fo, fb)},
               d_table_vs_other=_norm(da, db),
               d_table_bit_equal_to_other=bool(torch.equal(da, db)),
               this_bit_equal_to_itself=bool(torch.equal(da, da2)),
               this_vs_itself=_norm(da, da2),
               other_bit_equal_to_itself=bool(torch.equal(db, db2)),
               other_vs_itself=_norm(db, db2))

    # index_add_ on this build's rows, their unstored slots zeroed.
    this = steps["this"]
    dense = torch.where(this["stored"][:, :k, None].bool(), this["rows"], 0.0).view(-1, 6 + c)
    ids = binning.s_gid.long().repeat_interleave(k)
    lib_table = torch.zeros_like(this["table"])
    out = forward_buffers()
    timed = {}
    for name, lib in (("this", lib_a), ("other", lib_b)):
        timed[name] = {"fwd": lambda lib=lib: kernels.launch_forward(
            *args, *out, stats=True, lib=lib, **kw), "bwd": steps[name]["backward"]}
        if steps[name]["reduce"] is not None:
            timed[name]["reduce"] = steps[name]["reduce"]
    turns: dict = {}
    for name in ("this", "other", "other", "this"):
        for key, fn in timed[name].items():
            turns.setdefault(key, {}).setdefault(name, []).append(graph_ms(fn, RUNS))
    for key, by in turns.items():
        row[f"{key}_device_ms"] = {
            "this": float(np.mean(by["this"])) if "this" in by else None,
            "other": float(np.mean(by["other"])) if "other" in by else None,
            "turns": [by.get("this", [None])[0], *by.get("other", [None, None]),
                      by.get("this", [None, None])[-1]]}
    row["index_add_device_ms"] = graph_ms(lambda: lib_table.index_add_(0, ids, dense), RUNS)
    return row


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--other", required=True, help="root of the other checkout")
    p.add_argument("--cases", nargs="+", default=["15:15", "15:0", "32:15", "32:0"],
                   help="tile:F_lang pairs, or tile:F_lang:share of large splats")
    p.add_argument("--gaussians", type=int, default=30000)
    p.add_argument("--visible", type=int, default=None,
                   help="Gaussians in front of the camera (default: all)")
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
    if not takes_stored(lib_a):
        raise SystemExit("this build's reduce does not take `stored`")
    rows = []
    for case in args.cases:
        tile, f_lang, *large = case.split(":")
        row = dict(compare(lib_a, lib_b, tile=int(tile), f_lang=int(f_lang),
                           gaussians=args.gaussians, seed=args.seed, visible=args.visible,
                           large=float(large[0]) if large else 0.0), card=card)
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

"""Build and launch the hand-written kernels (csrc/*.cu): the blend's and
the preprocess's.

The CUDA sources have a plain C interface; each `.cu` is compiled with
`nvcc` for `sm_90a` (all at once, one process each) and linked into one
shared library at first use, loaded with ctypes. The library lands in
`build/torch_kernels/` at the repository root, keyed by a hash of the
sources and flags, so an edited source or header rebuilds and an
unchanged one is reused. Nothing here runs at import time.

The kernels take any tile >= 1 and, per launch, any channel count C =
F + 4 from MIN_CHANNELS to MAX_CHANNELS (tiled.py runs a wider C as
channel groups). The forward and backward are compiled once per width: an
EXACT instance for C = 4, 7 and 19 (the main path's widths, C fixed at
compile time) and a padded instance for each of PADDED_WIDTHS, which runs
any C up to its width (`instance_of`; `dispatch_width` in
csrc/blend_common.cuh). The reduce kernel is compiled per row width (6 +
C up to 16, 32, 64 or 70: its shared-memory rows) and per count K of CTAs per tile (1, 4, 9, 16 as constants, any
other at run time): `reduce_instance`. The backward's rows need no fill;
its `stored` flags (`flag_stride` bytes per instance) do, and the reduce
reads only the flagged rows. The preprocess kernels
(csrc/preprocess_fwd.cu, csrc/preprocess_bwd.cu) are compiled per SH
degree 0-3 and -1 (colours precomputed), the backward also per set of
gradients it writes (`preprocess_instance_names`).

`--fmad=false` keeps the kernels' float arithmetic operation for operation
the same as the JAX reference's (no fused multiply-adds the source does not
ask for), so the integer outputs (n_contrib, n_touched), which hinge on
float thresholds, match it exactly. The kernels write `__fmaf_rn` where no
threshold reads the result.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
MIN_CHANNELS, MAX_CHANNELS = 4, 64
EXACT_WIDTHS = (4, 7, 19)
PADDED_WIDTHS = (8, 12, 16, 20, 24, 28, 32, 48, 64)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The reduce kernel's compiled row widths (each runs any 6 + C up to it),
# and the CTAs per tile it is compiled for (any other K runs on the
# instance with K read at run time, named 0).
REDUCE_WIDTHS = (16, 32, 64, 6 + MAX_CHANNELS)
REDUCE_CTAS = (1, 4, 9, 16)
_EXTERN = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)

_lib = None
build_info: dict = {}


@dataclass
class KernelStats:
    """Launch counters of one kernel and of its plain version, in total and
    per channel count C (the preprocess's: per SH degree, -1 for precomputed
    colours); launches given their CTAs per tile K (the reduce's) also per
    "C/K". The threaded SLAM mode renders from two host threads, so every
    update holds the lock."""

    launches: int = 0
    plain_calls: int = 0
    launches_by_channels: dict[int, int] = field(default_factory=dict)
    plain_by_channels: dict[int, int] = field(default_factory=dict)
    launches_by_channels_ctas: dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                  compare=False)

    def count(self, channels: int, *, plain: bool, ctas: int | None = None) -> None:
        with self._lock:
            by = self.plain_by_channels if plain else self.launches_by_channels
            by[channels] = by.get(channels, 0) + 1
            if plain:
                self.plain_calls += 1
            else:
                self.launches += 1
                if ctas is not None:
                    key = f"{channels}/{ctas}"
                    by_k = self.launches_by_channels_ctas
                    by_k[key] = by_k.get(key, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.plain_calls = 0
            self.launches_by_channels.clear()
            self.plain_by_channels.clear()
            self.launches_by_channels_ctas.clear()


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the blend kernels "
                       "are built from csrc/ at first use")


def instance_of(channels: int) -> tuple[int, bool]:
    """(width, exact) of the compiled instance that runs `channels`."""
    if not MIN_CHANNELS <= channels <= MAX_CHANNELS:
        raise ValueError(f"one launch of the blend kernels takes {MIN_CHANNELS} to "
                         f"{MAX_CHANNELS} channels (tiled.channel_groups splits a wider "
                         f"C), got {channels}")
    if channels in EXACT_WIDTHS:
        return channels, True
    return next(w for w in PADDED_WIDTHS if w >= channels), False


def reduce_instance(channels: int, ctas: int) -> tuple[int, int]:
    """(row width, K) of the reduce kernel instance that runs `channels` at
    `ctas` CTAs per tile (K = 0: read at run time)."""
    instance_of(channels)  # the domain check
    if ctas < 1:
        raise ValueError(f"the reduce kernel takes K >= 1 CTAs per tile, got {ctas}")
    width = next(w for w in REDUCE_WIDTHS if 6 + channels <= w)
    return width, ctas if ctas in REDUCE_CTAS else 0


def instance_name(kernel: str, channels: int, ctas: int | None = None) -> str:
    """`instance_name("bwd", 27)` -> `bwd_kernel<28, false>`,
    `instance_name("reduce", 27, 4)` -> `reduce_kernel<64, 4>`, as
    `ptxas_summary` names them (the reduce's needs `ctas`)."""
    if kernel == "reduce":
        return "reduce_kernel<{}, {}>".format(*reduce_instance(channels, ctas))
    width, exact = instance_of(channels)
    return f"{kernel}_kernel<{width}, {str(exact).lower()}>"


def instances() -> list[tuple[int, bool]]:
    """Every compiled (width, exact) instance of the forward and backward."""
    return [(w, True) for w in EXACT_WIDTHS] + [(w, False) for w in PADDED_WIDTHS]


def instance_names() -> list[str]:
    """Every compiled blend kernel instance, as `ptxas_summary` names it."""
    reduce = sorted({reduce_instance(c, k) for c in range(MIN_CHANNELS, MAX_CHANNELS + 1)
                     for k in (*REDUCE_CTAS, REDUCE_CTAS[-1] + 1)})
    return ([instance_name(k, c) for k in ("fwd", "bwd") for c, _ in instances()]
            + ["reduce_kernel<{}, {}>".format(*r) for r in reduce])


def entry_points(csrc: Path = _CSRC) -> dict[str, list]:
    """The ctypes argument types of every `extern "C"` entry point of the
    sources in `csrc`, parsed from their signatures: a pointer (or the
    stream) is c_void_p, a float c_float, anything else c_int. Without them
    ctypes would pass every Python int as a 32-bit int and cut the
    pointers."""
    found = {}
    for src in sorted(csrc.glob("*.cu")):
        for name, params in _EXTERN.findall(src.read_text()):
            found[name] = [_P if "*" in p else (_F if p.split()[0] == "float" else _I)
                           for p in params.split(",")]
    return found


# The preprocess's SH degrees (-1: colours precomputed) and the sets of
# gradients its backward writes: (per-Gaussian, matrices).
PREPROCESS_DEGREES = (-1, 0, 1, 2, 3)
PREPROCESS_GRADS = ((True, True), (True, False), (False, True))


def preprocess_instance_names() -> list[str]:
    """Every compiled preprocess kernel instance, as `ptxas_summary` names
    it: `preprocess_fwd_kernel<0>`, `preprocess_bwd_kernel<3, false, true>`
    (degree, per-Gaussian gradients, matrix gradients), and the reduce."""
    flag = {True: "true", False: "false"}
    return ([f"preprocess_fwd_kernel<{d}>" for d in PREPROCESS_DEGREES]
            + [f"preprocess_bwd_kernel<{d}, {flag[g]}, {flag[m]}>"
               for d in PREPROCESS_DEGREES for g, m in PREPROCESS_GRADS]
            + ["preprocess_reduce_kernel"])


# This package's entry points and their signatures, read from csrc/.
ARGTYPES = entry_points()


def nvcc_commands(nvcc: str, out: Path, csrc: Path = _CSRC
                  ) -> tuple[list[list[str]], list[str]]:
    """The build: one compile per `.cu` of `csrc` (run together), then the
    link of their objects into one library."""
    objs, compiles = [], []
    for src in sorted(csrc.glob("*.cu")):
        obj = out.with_name(f"{out.name}.{src.stem}.o")
        objs.append(str(obj))
        compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    return compiles, [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                      "-o", str(out), *objs]


def library_path(csrc: Path = _CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """The library of `csrc`, named by a hash of every file there (an
    edited header rebuilds) and of the flags."""
    digest = hashlib.sha256()
    for src in sorted(p for p in csrc.iterdir() if p.is_file()):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"blend_{digest.hexdigest()[:16]}.so"


def build_library(csrc: Path = _CSRC, build_dir: Path = BUILD_DIR) -> tuple[ctypes.CDLL, dict]:
    """Build (unless a library of the same sources and flags exists) and
    load the kernels of `csrc` with their ctypes signatures; returns the
    library and its build's record (log, built, seconds, path)."""
    so = library_path(csrc, build_dir)
    info: dict = {}
    t0 = time.time()
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        compiles, link = nvcc_commands(_nvcc(), tmp, csrc)
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for cmd in compiles]
        logs = []
        for cmd, proc in zip(compiles, procs):
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{err}")
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        for obj in link[link.index(str(tmp)) + 1:]:
            os.remove(obj)
        os.replace(tmp, so)
        info.update(log="".join(logs), built=True)
    else:
        info["built"] = False
    info.update(seconds=time.time() - t0, path=str(so))
    lib = ctypes.CDLL(str(so))
    # Each checkout's library is bound by its own sources' signatures.
    for name, argtypes in entry_points(csrc).items():
        fn = getattr(lib, name, None)
        if fn is None:
            raise RuntimeError(f"{so} has no entry point {name}")
        fn.argtypes = argtypes
        fn.restype = _I
    return lib, info


def library() -> ctypes.CDLL:
    """Build (if needed) and load this package's kernel library."""
    global _lib
    if _lib is None:
        _lib, info = build_library()
        build_info.update(info)
    return _lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_NAMESPACED = re.compile(r"_ZN(\d+)")
_LENGTH = re.compile(r"\d+")
_TEMPLATE_ARG = re.compile(r"L([ib])(n?\d+)E")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def _kernel_name(mangled: str) -> str:
    """`_ZN5blend10bwd_kernelILi28ELb0EEEvPKf...` -> `bwd_kernel<28, false>`,
    `_ZN4prep21preprocess_fwd_kernelILin1EEEv...` ->
    `preprocess_fwd_kernel<-1>`, `_ZN4prep24preprocess_reduce_kernelEPKf...`
    -> `preprocess_reduce_kernel`: a kernel in a namespace, its template
    arguments if it has any."""
    m = _NAMESPACED.match(mangled)
    if not m:
        return mangled
    pos = m.end() + int(m.group(1))
    n = _LENGTH.match(mangled, pos)
    if not n:
        return mangled
    name = mangled[n.end():n.end() + int(n.group())]
    rest = mangled[n.end() + len(name):]
    if not rest.startswith("I"):
        return name
    args = [v.replace("n", "-") if kind == "i" else ("true" if v == "1" else "false")
            for kind, v in _TEMPLATE_ARG.findall(rest[:rest.index("EEv")])]
    return f"{name}<{', '.join(args)}>"


def ptxas_summary(log: str) -> list[dict]:
    """Registers, spills and static shared memory of every kernel instance
    from nvcc's `-Xptxas -v` output."""
    rows, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1))}
            rows.append(cur)
            continue
        if cur is None:
            continue
        if (m := _SPILL.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        if (m := _USED.search(line)):
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            cur["smem"] = int(s.group(1)) if s else 0
    return rows


def occupancy(kernel: str, channels: int, ctas: int | None = None) -> int:
    """CTAs of the forward (`"fwd"`), backward (`"bwd"`) or reduce
    (`"reduce"`, at `ctas` CTAs per tile) kernel resident on one SM of the
    current card, with their dynamic shared memory."""
    blocks = ctypes.c_int(0)
    args = (channels, ctas) if kernel == "reduce" else (channels,)
    err = getattr(library(), f"blend_{kernel}_occupancy")(*args, ctypes.byref(blocks))
    _raise_on(err, f"blend_{kernel}_occupancy")
    return blocks.value


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def launch_forward(geom, feat, s_gid, starts, tile_counts, feat_img, final_t,
                   n_contrib, n_touched, *, channels: int, width: int,
                   height: int, tile: int, stats: bool, py_limit: int | None = None,
                   lib: ctypes.CDLL | None = None):
    """The forward kernel (of `lib`, default this package's); n_touched
    counts the rows py < `py_limit` (default: all `height` rows)."""
    lib = lib or library()
    # A launch goes to the thread's current device: the tensors' card (a
    # mesh spreads renders over several cards).
    with torch.cuda.device(feat.device):
        err = lib.blend_fwd(
            geom.data_ptr(), feat.data_ptr(), s_gid.data_ptr(), starts.data_ptr(),
            tile_counts.data_ptr(), feat_img.data_ptr(), final_t.data_ptr(),
            n_contrib.data_ptr(), n_touched.data_ptr(), channels, width, height,
            tile, int(stats), height if py_limit is None else py_limit, _stream(feat))
    _raise_on(err, "blend_fwd launch")


def ctas_per_tile(tile: int) -> int:
    """K: the CTAs of a tile, each a square of at most 16x16 pixels
    (csrc/blend_common.cuh: make_geometry)."""
    quad = min(tile, 16)
    return (-(-tile // quad)) ** 2


def flag_stride(ctas: int) -> int:
    """Bytes of `stored` flags per instance: K, padded to whole 32-bit
    words when K > 1 (csrc/blend_common.cuh: flag_stride)."""
    return 1 if ctas == 1 else -(-ctas // 4) * 4


def launch_backward(geom, feat, s_gid, starts, tile_counts, g_feat, g_t,
                    feat_img, final_t, rows, stored, *, channels: int,
                    width: int, height: int, tile: int,
                    lib: ctypes.CDLL | None = None):
    """The backward's rows kernel: per sorted instance and CTA of its tile
    that a pixel's contribution reached, the instance's 6 + C values summed
    over the CTA's pixels into `rows` (S, ctas_per_tile(tile), 6 + C), and
    a 1 into `stored` (S, flag_stride(K)) uint8, which must be zero; the
    other rows are left as they were."""
    lib = lib or library()
    with torch.cuda.device(feat.device):
        err = lib.blend_bwd(
            geom.data_ptr(), feat.data_ptr(), s_gid.data_ptr(), starts.data_ptr(),
            tile_counts.data_ptr(), g_feat.data_ptr(), g_t.data_ptr(),
            feat_img.data_ptr(), final_t.data_ptr(), rows.data_ptr(), stored.data_ptr(),
            channels, width, height, tile, _stream(feat))
    _raise_on(err, "blend_bwd launch")


def launch_reduce(rows, stored, s_gid, emit_inst, emit_start, emit_count, d_table, *,
                  channels: int, lib: ctypes.CDLL | None = None):
    """The reduce kernel: d_table (P, 6 + C) = the stored rows of `rows`
    (S, K, 6 + C) summed per Gaussian in emission order, each instance's
    stored rows first, in k order; `s_gid` (S,) is the binning's Gaussian
    per sorted instance. d_table must be 16-byte aligned."""
    lib = lib or library()
    if d_table.data_ptr() % 16:
        raise ValueError("d_table must be 16-byte aligned")
    with torch.cuda.device(rows.device):
        err = lib.blend_reduce(
            rows.data_ptr(), stored.data_ptr(), s_gid.data_ptr(), emit_inst.data_ptr(),
            emit_start.data_ptr(), emit_count.data_ptr(), d_table.data_ptr(), channels,
            d_table.shape[0], rows.shape[0], rows.shape[1], _stream(rows))
    _raise_on(err, "blend_reduce launch")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch_preprocess_forward(inputs, outputs, *, sh_degree: int, sh_coeffs: int,
                              width: int, height: int, tile: int, focal_x: float,
                              focal_y: float, lim_x: float, lim_y: float,
                              scale_modifier: float, lib: ctypes.CDLL | None = None):
    """The forward preprocess kernel. `inputs`: means3d, scales, quats,
    opacities, shs, cov3d, view, full_proj, campos, means2d_offset (None
    where unused); `outputs`: xy, depth, conic, color (None at sh_degree
    -1), valid, radius, rect_min, rect_max, tiles_touched, preallocated."""
    lib = lib or library()
    means3d = inputs[0]
    with torch.cuda.device(means3d.device):
        err = lib.preprocess_fwd(
            *map(_ptr, inputs), *map(_ptr, outputs), means3d.shape[0], sh_degree, sh_coeffs,
            width, height, tile, focal_x, focal_y, lim_x, lim_y, scale_modifier,
            _stream(means3d))
    _raise_on(err, "preprocess_fwd launch")


def preprocess_blocks(gaussians: int) -> int:
    """Rows of matrix partials the backward kernel writes: one per CTA of
    256 Gaussians (csrc/preprocess_common.cuh: BLOCK)."""
    return -(-gaussians // 256)


def launch_preprocess_backward(inputs, cotangents, grads, partials, *, sh_degree: int,
                               sh_coeffs: int, width: int, height: int, focal_x: float,
                               focal_y: float, lim_x: float, lim_y: float,
                               scale_modifier: float, lib: ctypes.CDLL | None = None):
    """The backward preprocess kernel. `inputs`: means3d, scales, quats,
    shs, cov3d, view, full_proj, campos; `cotangents`: xy, depth, conic,
    color, each None (zero) or a tensor whose rows hold adjacent entries;
    `grads`: means3d, scales, quats, shs, cov3d, all None unless the
    per-Gaussian gradients are wanted; `partials` (preprocess_blocks(P),
    32) or None unless the matrices' gradients are."""
    lib = lib or library()
    means3d = inputs[0]
    strides = [0 if g is None else g.stride(0) for g in cotangents]
    with torch.cuda.device(means3d.device):
        err = lib.preprocess_bwd(
            *map(_ptr, inputs), *map(_ptr, cotangents), *map(_ptr, grads), _ptr(partials),
            means3d.shape[0], sh_degree, sh_coeffs, int(grads[0] is not None),
            int(partials is not None), *strides, width, height, focal_x, focal_y, lim_x,
            lim_y, scale_modifier, _stream(means3d))
    _raise_on(err, "preprocess_bwd launch")


def launch_preprocess_reduce(partials: torch.Tensor, out: torch.Tensor,
                             lib: ctypes.CDLL | None = None):
    """out (2, 4, 4) = dL/d(view), dL/d(full_proj): the backward's per-CTA
    partials summed in a fixed order."""
    lib = lib or library()
    with torch.cuda.device(partials.device):
        err = lib.preprocess_reduce(partials.data_ptr(), out.data_ptr(), partials.shape[0],
                                    _stream(partials))
    _raise_on(err, "preprocess_reduce launch")

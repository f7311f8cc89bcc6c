"""Build and launch the hand-written blend kernels (csrc/*.cu).

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
csrc/blend_common.cuh). The reduce kernel is compiled once per count of
values a lane sums (`reduce_instance`: 1, 2 or 3 of the 6 + C).

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
import time
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

_P, _I = ctypes.c_void_p, ctypes.c_int
# ctypes signatures of the extern "C" entry points, in source order: a
# pointer (or the stream) is c_void_p, an int c_int. Without them ctypes
# would pass every Python int as a 32-bit int and cut the pointers.
ARGTYPES = {
    "blend_fwd": [_P] * 9 + [_I] * 6 + [_P],
    "blend_bwd": [_P] * 10 + [_I] * 4 + [_P],
    "blend_reduce": [_P] * 5 + [_I] * 3 + [_P],
    "blend_fwd_occupancy": [_I, _P],
    "blend_bwd_occupancy": [_I, _P],
    "blend_reduce_occupancy": [_I, _P],
}

_lib = None
build_info: dict = {}


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


def reduce_instance(channels: int) -> int:
    """Values per lane of the reduce kernel instance that runs `channels`:
    ceil((6 + C) / 32)."""
    instance_of(channels)  # the domain check
    return (6 + channels + 31) // 32


def instance_name(kernel: str, channels: int) -> str:
    """`instance_name("bwd", 27)` -> `bwd_kernel<28, false>`,
    `instance_name("reduce", 27)` -> `reduce_kernel<2>`, as `ptxas_summary`
    names them."""
    if kernel == "reduce":
        return f"reduce_kernel<{reduce_instance(channels)}>"
    width, exact = instance_of(channels)
    return f"{kernel}_kernel<{width}, {str(exact).lower()}>"


def instances() -> list[tuple[int, bool]]:
    """Every compiled (width, exact) instance of the forward and backward."""
    return [(w, True) for w in EXACT_WIDTHS] + [(w, False) for w in PADDED_WIDTHS]


def instance_names() -> list[str]:
    """Every compiled kernel instance, as `ptxas_summary` names it."""
    vpl = sorted({reduce_instance(c) for c in range(MIN_CHANNELS, MAX_CHANNELS + 1)})
    return ([instance_name(k, c) for k in ("fwd", "bwd") for c, _ in instances()]
            + [f"reduce_kernel<{v}>" for v in vpl])


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
    for name, argtypes in ARGTYPES.items():
        # Another checkout's sources may predate an entry point (the reduce
        # kernel); this package's must have every one.
        fn = getattr(lib, name, None)
        if fn is None:
            if csrc == _CSRC:
                raise RuntimeError(f"{so} has no entry point {name}")
            continue
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
_KERNEL = re.compile(r"_ZN5blend(\d+)(\w+?)I(.*)EEvP")
_TEMPLATE_ARG = re.compile(r"L([ib])(\d+)E")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def _kernel_name(mangled: str) -> str:
    """`_ZN5blend10bwd_kernelILi28ELb0EEEvPKf...` -> `bwd_kernel<28, false>`."""
    m = _KERNEL.match(mangled)
    if not m:
        return mangled
    name = m.group(2)[:int(m.group(1))]
    args = [v if kind == "i" else ("true" if v == "1" else "false")
            for kind, v in _TEMPLATE_ARG.findall(m.group(3))]
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


def occupancy(kernel: str, channels: int) -> int:
    """CTAs of the forward (`"fwd"`), backward (`"bwd"`) or reduce
    (`"reduce"`) kernel resident on one SM of the current card, with their
    dynamic shared memory."""
    blocks = ctypes.c_int(0)
    err = getattr(library(), f"blend_{kernel}_occupancy")(channels, ctypes.byref(blocks))
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


def launch_backward(geom, feat, s_gid, starts, tile_counts, g_feat, g_t,
                    feat_img, final_t, rows, *, channels: int, width: int,
                    height: int, tile: int, lib: ctypes.CDLL | None = None):
    """The backward's rows kernel: per sorted instance and CTA of its tile,
    the instance's 6 + C values summed over the CTA's pixels, into `rows`
    (S, ctas_per_tile(tile), 6 + C), which must be zero. (Another
    checkout's atomic form writes d_table (P, 6 + C) here instead.)"""
    lib = lib or library()
    with torch.cuda.device(feat.device):
        err = lib.blend_bwd(
            geom.data_ptr(), feat.data_ptr(), s_gid.data_ptr(), starts.data_ptr(),
            tile_counts.data_ptr(), g_feat.data_ptr(), g_t.data_ptr(),
            feat_img.data_ptr(), final_t.data_ptr(), rows.data_ptr(), channels,
            width, height, tile, _stream(feat))
    _raise_on(err, "blend_bwd launch")


def launch_reduce(rows, emit_inst, emit_start, emit_count, d_table, *,
                  channels: int, lib: ctypes.CDLL | None = None):
    """The reduce kernel: d_table (P, 6 + C) = the rows (S, K, 6 + C)
    summed per Gaussian in emission order, each instance's K rows first."""
    lib = lib or library()
    with torch.cuda.device(rows.device):
        err = lib.blend_reduce(
            rows.data_ptr(), emit_inst.data_ptr(), emit_start.data_ptr(),
            emit_count.data_ptr(), d_table.data_ptr(), channels, d_table.shape[0],
            rows.shape[1], _stream(rows))
    _raise_on(err, "blend_reduce launch")

"""Build and launch the hand-written blend kernels (csrc/*.cu).

The CUDA sources have a plain C interface; they are compiled with `nvcc`
for `sm_90a` into one shared library at first use and loaded with ctypes.
The library lands in `build/torch_kernels/` at the repository root, keyed by
a hash of the sources and flags, so an edited source or header rebuilds
and an unchanged one is reused. Nothing here runs at import time.

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
_SOURCES = ("blend_common.cuh", "blend_fwd.cu", "blend_bwd.cu")
_REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# ctypes signatures of the extern "C" entry points, in source order: a
# pointer (or the stream) is c_void_p, an int c_int. Without them ctypes
# would pass every Python int as a 32-bit int and cut the pointers.
ARGTYPES = {
    "blend_fwd": [_P] * 9 + [_I] * 6 + [_P],
    "blend_bwd": [_P] * 10 + [_I] * 4 + [_P],
    "blend_fwd_occupancy": [_I, _P],
    "blend_bwd_occupancy": [_I, _P],
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


def nvcc_command(nvcc: str, out: Path) -> list[str]:
    """The build command: every `.cu` of `_SOURCES` into one library."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out),
            *(str(_CSRC / s) for s in _SOURCES if s.endswith(".cu"))]


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"blend_{digest.hexdigest()[:16]}.so"
    t0 = time.time()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(nvcc_command(_nvcc(), tmp), capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
        build_info["log"] = res.stderr
        build_info["built"] = True
    else:
        build_info["built"] = False
    build_info["seconds"] = time.time() - t0
    build_info["path"] = str(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    _lib = lib
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_KERNEL = re.compile(r"_ZN5blend(\d+)(\w+?)I(.*)EEvP")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def _kernel_name(mangled: str) -> str:
    """`_ZN5blend10bwd_kernelILi19EEEvPKf...` -> `bwd_kernel<19>`."""
    m = _KERNEL.match(mangled)
    if not m:
        return mangled
    name = m.group(2)[:int(m.group(1))]
    return f"{name}<{', '.join(re.findall(r'Li(\d+)E', m.group(3)))}>"


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
    """CTAs of the forward (`"fwd"`) or backward (`"bwd"`) kernel resident
    on one SM of the current card, with their dynamic shared memory."""
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
                   height: int, tile: int, stats: bool, py_limit: int | None = None):
    """The forward kernel; n_touched counts the rows py < `py_limit`
    (default: all `height` rows)."""
    lib = library()
    # A launch goes to the thread's current device: the tensors' card (a
    # mesh spreads renders over several cards).
    with torch.cuda.device(feat.device):
        err = lib.blend_fwd(
            geom.data_ptr(), feat.data_ptr(), s_gid.data_ptr(), starts.data_ptr(),
            tile_counts.data_ptr(), feat_img.data_ptr(), final_t.data_ptr(),
            n_contrib.data_ptr(), n_touched.data_ptr(), channels, width, height,
            tile, int(stats), height if py_limit is None else py_limit, _stream(feat))
    _raise_on(err, "blend_fwd launch")


def launch_backward(geom, feat, s_gid, starts, tile_counts, g_feat, g_t,
                    feat_img, final_t, d_table, *, channels: int, width: int,
                    height: int, tile: int):
    lib = library()
    with torch.cuda.device(feat.device):
        err = lib.blend_bwd(
            geom.data_ptr(), feat.data_ptr(), s_gid.data_ptr(), starts.data_ptr(),
            tile_counts.data_ptr(), g_feat.data_ptr(), g_t.data_ptr(),
            feat_img.data_ptr(), final_t.data_ptr(), d_table.data_ptr(), channels,
            width, height, tile, _stream(feat))
    _raise_on(err, "blend_bwd launch")

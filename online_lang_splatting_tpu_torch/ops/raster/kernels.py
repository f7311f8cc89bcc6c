"""Build and launch the hand-written blend kernels (csrc/*.cu).

The CUDA sources have a plain C interface; they are compiled with `nvcc`
for `sm_90a` into one shared library at first use and loaded with ctypes.
The library lands in `build/torch_kernels/` at the repository root, keyed by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time.

`--fmad=false` keeps the kernels' float arithmetic operation for operation
the same as the JAX reference's (no fused multiply-adds), so the integer
outputs (n_contrib, n_touched), which hinge on float thresholds, match it
exactly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(_CSRC / "blend_fwd.cu"), str(_CSRC / "blend_bwd.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blend_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.blend_fwd.restype = i
    lib.blend_bwd.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.blend_bwd.restype = i
    _lib = lib
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def launch_forward(geom, feat, s_gid, starts, tile_counts, feat_img, final_t,
                   n_contrib, n_touched, *, channels: int, width: int,
                   height: int, tile: int, stats: bool):
    lib = library()
    err = lib.blend_fwd(
        geom.data_ptr(), feat.data_ptr(), s_gid.data_ptr(), starts.data_ptr(),
        tile_counts.data_ptr(), feat_img.data_ptr(), final_t.data_ptr(),
        n_contrib.data_ptr(), n_touched.data_ptr(), channels, width, height,
        tile, int(stats), _stream(feat))
    _raise_on(err, "blend_fwd")


def launch_backward(geom, feat, s_gid, starts, tile_counts, g_feat, g_t,
                    feat_img, final_t, d_table, *, channels: int, width: int,
                    height: int, tile: int):
    lib = library()
    err = lib.blend_bwd(
        geom.data_ptr(), feat.data_ptr(), s_gid.data_ptr(), starts.data_ptr(),
        tile_counts.data_ptr(), g_feat.data_ptr(), g_t.data_ptr(),
        feat_img.data_ptr(), final_t.data_ptr(), d_table.data_ptr(), channels,
        width, height, tile, _stream(feat))
    _raise_on(err, "blend_bwd")

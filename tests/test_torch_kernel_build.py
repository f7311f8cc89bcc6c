"""The kernel build's bookkeeping, checked without nvcc.

- every file under csrc/ is hashed into the library's name (an edited
  header rebuilds);
- every `.cu` is in the nvcc command;
- the ctypes signatures match the `extern "C"` entry points parsed from the
  sources, pointer for pointer and int for int (a mismatch would pass a
  pointer as a 32-bit int);
- the ptxas summary that chip_smoke.py prints parses nvcc's `-Xptxas -v`
  lines per kernel instance.
"""

import ctypes
import re
from pathlib import Path

import pytest

import torch_helpers  # noqa: F401  (sets the torch thread count)

from online_lang_splatting_tpu_torch.ops.raster import kernels

CSRC = Path(kernels._CSRC)
_EXTERN = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def _entry_points() -> dict:
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in _EXTERN.findall(src.read_text()):
            found[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                           for p in params.split(",")]
    return found


def test_every_source_is_hashed():
    on_disk = sorted(p.name for p in CSRC.iterdir() if p.is_file())
    assert on_disk and sorted(kernels._SOURCES) == on_disk


def test_every_cu_is_compiled():
    cmd = kernels.nvcc_command("nvcc", Path("/tmp/out.so"))
    compiled = sorted(Path(a).name for a in cmd if a.endswith(".cu"))
    assert compiled == sorted(p.name for p in CSRC.glob("*.cu"))
    assert "--fmad=false" in cmd and "arch=compute_90a,code=sm_90a" in cmd


def test_entry_points_are_all_bound():
    assert set(_entry_points()) == set(kernels.ARGTYPES)


@pytest.mark.parametrize("name", sorted(kernels.ARGTYPES))
def test_argtypes_match_the_c_signature(name):
    parsed = _entry_points()[name]
    assert kernels.ARGTYPES[name] == parsed, (
        name, [t.__name__ for t in kernels.ARGTYPES[name]], [t.__name__ for t in parsed])


_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5blend10bwd_kernelILi19EEEvPKfS2_PKiS4_S4_S2_S2_S2_S2_PfNS_12TileGeometryE' for 'sm_90a'
ptxas info    : Function properties for _ZN5blend10bwd_kernelILi19EEEvPKfS2_PKiS4_S4_S2_S2_S2_S2_PfNS_12TileGeometryE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5blend10fwd_kernelILi4EEEvPKfS2_PKiS4_S4_PfS5_PiS6_NS_12TileGeometryEi' for 'sm_90a'
ptxas info    : Function properties for _ZN5blend10fwd_kernelILi4EEEvPKfS2_PKiS4_S4_PfS5_PiS6_NS_12TileGeometryEi
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 16 bytes smem, 404 bytes cmem[0]
"""


def test_ptxas_summary_names_each_instance():
    rows = kernels.ptxas_summary(_LOG)
    assert rows == [
        {"kernel": "bwd_kernel<19>", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 80, "smem": 0},
        {"kernel": "fwd_kernel<4>", "stack": 8, "spill_stores": 4,
         "spill_loads": 12, "registers": 40, "smem": 16},
    ]
    assert kernels.ptxas_summary("") == []


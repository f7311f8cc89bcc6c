"""The kernel build's bookkeeping, checked without nvcc.

- every file under csrc/ is hashed into the library's name (an edited
  header rebuilds);
- every `.cu` is in the nvcc command;
- the ctypes signatures match the `extern "C"` entry points parsed from the
  sources, pointer for pointer and int for int (a mismatch would pass a
  pointer as a 32-bit int);
- the ptxas summary that chip_smoke.py prints parses nvcc's `-Xptxas -v`
  lines per kernel instance, the reduce kernel's included, and the reduce
  kernel's instances are the values per lane its dispatch routes to.
"""

import ctypes
import re
import shutil
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


def test_every_source_is_hashed(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    names = sorted(p.name for p in csrc.iterdir())
    assert {"blend_common.cuh", "blend_fwd.cu", "blend_bwd.cu", "blend_reduce.cu"} <= set(names)
    seen = {kernels.library_path(csrc, tmp_path)}
    assert seen == {kernels.library_path(CSRC, tmp_path)}
    for name in names:
        with open(csrc / name, "a") as f:
            f.write("\n")
        seen.add(kernels.library_path(csrc, tmp_path))
    assert len(seen) == len(names) + 1


def test_every_cu_is_compiled():
    out = Path("/tmp/out.so")
    compiles, link = kernels.nvcc_commands("nvcc", out)
    sources = sorted(Path(cmd[-1]).name for cmd in compiles)
    assert sources == sorted(p.name for p in CSRC.glob("*.cu"))
    for cmd in compiles:
        assert "--fmad=false" in cmd and "arch=compute_90a,code=sm_90a" in cmd
        assert "-c" in cmd and cmd[cmd.index("-o") + 1] in link
    assert link[link.index("-o") + 1] == str(out) and "-shared" in link


def test_entry_points_are_all_bound():
    assert set(_entry_points()) == set(kernels.ARGTYPES)


@pytest.mark.parametrize("name", sorted(kernels.ARGTYPES))
def test_argtypes_match_the_c_signature(name):
    parsed = _entry_points()[name]
    assert kernels.ARGTYPES[name] == parsed, (
        name, [t.__name__ for t in kernels.ARGTYPES[name]], [t.__name__ for t in parsed])


_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5blend10bwd_kernelILi19ELb1EEEvPKfS2_PKiS4_S4_S2_S2_S2_S2_PfNS_12TileGeometryEi' for 'sm_90a'
ptxas info    : Function properties for _ZN5blend10bwd_kernelILi19ELb1EEEvPKfS2_PKiS4_S4_S2_S2_S2_S2_PfNS_12TileGeometryEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5blend10fwd_kernelILi28ELb0EEEvPKfS2_PKiS4_S4_PfS5_PiS6_NS_12TileGeometryEiii' for 'sm_90a'
ptxas info    : Function properties for _ZN5blend10fwd_kernelILi28ELb0EEEvPKfS2_PKiS4_S4_PfS5_PiS6_NS_12TileGeometryEiii
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 16 bytes smem, 404 bytes cmem[0]
"""


def _entry(kernel: str, width: int, exact: bool) -> str:
    name = f"{kernel}_kernel"
    return (f"ptxas info    : Compiling entry function '_ZN5blend{len(name)}{name}ILi{width}"
            f"ELb{int(exact)}EEEvPKfS2_PKiS4_S4_PfNS_12TileGeometryEi' for 'sm_90a'\n"
            f"ptxas info    : Used {width + 40} registers, used 1 barriers\n")


def test_ptxas_summary_names_each_instance():
    rows = kernels.ptxas_summary(_LOG)
    assert rows == [
        {"kernel": "bwd_kernel<19, true>", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 80, "smem": 0},
        {"kernel": "fwd_kernel<28, false>", "stack": 8, "spill_stores": 4,
         "spill_loads": 12, "registers": 40, "smem": 16},
    ]
    assert kernels.ptxas_summary("") == []
    # Every compiled instance, named as chip_smoke.py looks it up.
    log = "".join(_entry(k, w, e) for k in ("fwd", "bwd") for w, e in kernels.instances())
    names = [row["kernel"] for row in kernels.ptxas_summary(log)]
    assert names == [kernels.instance_name(k, w) for k in ("fwd", "bwd")
                     for w, _ in kernels.instances()]
    assert len(set(names)) == 2 * len(kernels.instances())


_EXACT_CASE = re.compile(r"case (\d+): return f\.template operator\(\)<(\d+), true>\(\);")
_PADDED_CASE = re.compile(r"return f\.template operator\(\)<(\d+), false>\(\);")


def test_dispatch_widths_match_the_source():
    """The widths blend_common.cuh's dispatch_width compiles and routes to
    are kernels.py's (instance_of), and so is the domain."""
    src = (CSRC / "blend_common.cuh").read_text()
    body = src[src.index("cudaError_t dispatch_width("):]
    body = body[:body.index("\n}\n")]
    exact = [(int(a), int(b)) for a, b in _EXACT_CASE.findall(body)]
    assert all(a == b for a, b in exact)
    assert tuple(a for a, _ in exact) == kernels.EXACT_WIDTHS
    assert tuple(int(w) for w in _PADDED_CASE.findall(body)) == kernels.PADDED_WIDTHS
    lo, hi = re.search(r"MIN_CHANNELS = (\d+), MAX_CHANNELS = (\d+);", src).groups()
    assert (int(lo), int(hi)) == (kernels.MIN_CHANNELS, kernels.MAX_CHANNELS)
    assert kernels.PADDED_WIDTHS[-1] == kernels.MAX_CHANNELS
    # The C-side routing, replayed: the first padded width >= C unless C
    # has an exact instance.
    for c in range(kernels.MIN_CHANNELS, kernels.MAX_CHANNELS + 1):
        want = (c, True) if c in kernels.EXACT_WIDTHS else (
            min(w for w in kernels.PADDED_WIDTHS if w >= c), False)
        assert kernels.instance_of(c) == want
        conds = [int(w) for w in re.findall(r"if \(C <= (\d+)\) return", body)]
        if c not in kernels.EXACT_WIDTHS:
            routed = next((w for w in conds if c <= w), kernels.PADDED_WIDTHS[-1])
            assert routed == want[0]


def _reduce_entry(vpl: int) -> str:
    return (f"ptxas info    : Compiling entry function '_ZN5blend13reduce_kernelILi{vpl}"
            f"EEEvPKfPKiS4_S4_Pfiii' for 'sm_90a'\n"
            f"ptxas info    : Function properties for _ZN5blend13reduce_kernelILi{vpl}"
            f"EEEvPKfPKiS4_S4_Pfiii\n"
            f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            f"ptxas info    : Used {30 + vpl} registers, used 0 barriers, 392 bytes cmem[0]\n")


def test_ptxas_summary_names_the_reduce_instances():
    log = ("".join(_entry(k, w, e) for k in ("fwd", "bwd") for w, e in kernels.instances())
           + "".join(_reduce_entry(v) for v in (1, 2, 3)))
    rows = kernels.ptxas_summary(log)
    assert [row["kernel"] for row in rows] == kernels.instance_names()
    assert rows[-3:] == [{"kernel": f"reduce_kernel<{v}>", "stack": 0, "spill_stores": 0,
                          "spill_loads": 0, "registers": 30 + v, "smem": 0} for v in (1, 2, 3)]
    assert [kernels.instance_name("reduce", c) for c in (4, 26, 27, 58, 59, 64)] == [
        "reduce_kernel<1>", "reduce_kernel<1>", "reduce_kernel<2>", "reduce_kernel<2>",
        "reduce_kernel<3>", "reduce_kernel<3>"]


def test_reduce_instances_match_the_source():
    """dispatch_vpl in blend_reduce.cu routes G = 6 + C to ceil(G / 32)
    values per lane, as kernels.reduce_instance does, over the same domain."""
    src = (CSRC / "blend_reduce.cu").read_text()
    body = src[src.index("cudaError_t dispatch_vpl("):]
    body = body[:body.index("\n}\n")]
    cases = {int(a): int(b) for a, b in re.findall(
        r"case (\d+): return f\.template operator\(\)<(\d+)>\(\);", body)}
    assert cases == {1: 1, 2: 2} and "operator()<MAX_VPL>()" in body
    assert "(6 + C + 31) / 32" in body
    assert "MAX_VPL = (6 + MAX_CHANNELS + 31) / 32" in src
    for c in range(kernels.MIN_CHANNELS, kernels.MAX_CHANNELS + 1):
        assert kernels.reduce_instance(c) == cases.get((6 + c + 31) // 32, 3)
    for c in (kernels.MIN_CHANNELS - 1, kernels.MAX_CHANNELS + 1):
        with pytest.raises(ValueError):
            kernels.reduce_instance(c)


def test_the_backward_sums_with_no_float_atomic():
    """The rows and reduce kernels take every sum in an order the data
    fixes: no atomicAdd in their sources."""
    for name in ("blend_bwd.cu", "blend_reduce.cu"):
        code = re.sub(r"//[^\n]*", "", (CSRC / name).read_text())
        assert "atomic" not in code, name


def test_ctas_per_tile_is_the_kernels_split():
    """K = ceil(tile / quad)^2 with quad = min(tile, 16), as make_geometry
    in blend_common.cuh splits a tile."""
    assert [kernels.ctas_per_tile(t) for t in (1, 8, 15, 16, 17, 24, 32, 48, 64)] == [
        1, 1, 1, 1, 4, 4, 4, 9, 16]

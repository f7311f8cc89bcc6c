"""The kernel build's bookkeeping, checked without nvcc.

- every file under csrc/ is hashed into the library's name (an edited
  header rebuilds);
- every `.cu` is in the nvcc command;
- the ctypes signatures parsed from the sources' `extern "C"` entry points
  are the ABI the launch wrappers call, pointer for pointer and int for int
  (a mismatch would pass a pointer as a 32-bit int);
- the ptxas summary that chip_smoke.py prints parses nvcc's `-Xptxas -v`
  lines per kernel instance, the reduce kernel's included, and the reduce
  kernel's instances are the lane layouts and CTAs per tile its dispatch
  routes to;
- the `stored` flags' stride per instance is the sources', and another
  checkout's library is bound by its own signatures (tools/blend_ab.py).
"""

import ctypes
import re
import shutil
from pathlib import Path

import pytest

import torch_helpers  # noqa: F401  (sets the torch thread count)

from online_lang_splatting_tpu_torch.ops.raster import kernels

CSRC = Path(kernels._CSRC)
# The entry points' ABI as the launch wrappers call it: P a pointer (or the
# stream), I an int, F a float, in order.
_ABI = {
    "blend_fwd": "P" * 9 + "I" * 6 + "P",
    "blend_bwd": "P" * 11 + "I" * 4 + "P",
    "blend_reduce": "P" * 7 + "I" * 4 + "P",
    "blend_fwd_occupancy": "IP",
    "blend_bwd_occupancy": "IP",
    "blend_reduce_occupancy": "IIP",
    "preprocess_fwd": "P" * 19 + "I" * 6 + "F" * 5 + "P",
    "preprocess_bwd": "P" * 18 + "I" * 11 + "F" * 5 + "P",
    "preprocess_reduce": "PPIP",
}
_CTYPE = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}


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
    assert set(kernels.ARGTYPES) == set(_ABI)
    assert kernels.ARGTYPES == kernels.entry_points(CSRC)


@pytest.mark.parametrize("name", sorted(kernels.ARGTYPES))
def test_argtypes_match_the_c_signature(name):
    want = [_CTYPE[x] for x in _ABI[name]]
    assert kernels.ARGTYPES[name] == want, (
        name, [t.__name__ for t in kernels.ARGTYPES[name]], [t.__name__ for t in want])


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


_REDUCE_WIDTHS = (16, 32, 64, 70)


def _reduce_entry(width: int, k: int) -> str:
    name = f"_ZN5blend13reduce_kernelILi{width}ELi{k}EEEvPKfPKhPKiS6_S6_S6_Pfiiii"
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            f"ptxas info    : Used {30 + k} registers, used 1 barriers, "
            f"{width * 512} bytes smem, 400 bytes cmem[0]\n")


def test_ptxas_summary_names_the_reduce_instances():
    ks = (0, 1, 4, 9, 16)
    log = ("".join(_entry(k, w, e) for k in ("fwd", "bwd") for w, e in kernels.instances())
           + "".join(_reduce_entry(w, k) for w in _REDUCE_WIDTHS for k in ks))
    rows = kernels.ptxas_summary(log)
    assert [row["kernel"] for row in rows] == kernels.instance_names()
    assert rows[-len(ks) * 4:] == [
        {"kernel": f"reduce_kernel<{w}, {k}>", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 30 + k, "smem": w * 512}
        for w in _REDUCE_WIDTHS for k in ks]
    assert [kernels.instance_name("reduce", c, 4) for c in (4, 10, 11, 26, 27, 58, 59, 64)] == [
        "reduce_kernel<16, 4>", "reduce_kernel<16, 4>", "reduce_kernel<32, 4>",
        "reduce_kernel<32, 4>", "reduce_kernel<64, 4>", "reduce_kernel<64, 4>",
        "reduce_kernel<70, 4>", "reduce_kernel<70, 4>"]
    assert [kernels.instance_name("reduce", 19, kernels.ctas_per_tile(t))
            for t in (8, 16, 24, 32, 40, 48, 64, 80)] == [
        f"reduce_kernel<32, {k}>" for k in (1, 1, 4, 4, 9, 9, 16, 0)]


def test_reduce_instances_match_the_source():
    """dispatch_reduce in blend_reduce.cu routes G = 6 + C to the smallest
    compiled row width >= G, and dispatch_ctas K to its constant or to the
    runtime-K instance, as kernels.reduce_instance does, over the same
    domain."""
    src = (CSRC / "blend_reduce.cu").read_text()
    body = src[src.index("cudaError_t dispatch_reduce("):]
    body = body[:body.index("\n}\n")]
    routed = [(int(top), int(w)) for top, w in re.findall(
        r"if \(G <= (\d+)\) return dispatch_ctas<(\d+)>", body)]
    last = int(re.search(r"\n  return dispatch_ctas<(\d+)>", body).group(1))
    assert all(top == w for top, w in routed)
    assert tuple(w for _, w in routed) + (last,) == kernels.REDUCE_WIDTHS == _REDUCE_WIDTHS
    assert last == 6 + kernels.MAX_CHANNELS
    ctas = src[src.index("cudaError_t dispatch_ctas("):]
    ctas = ctas[:ctas.index("\n}\n")]
    cases = [(int(a), int(b)) for a, b in re.findall(
        r"case (\d+): return f\.template operator\(\)<GMAX, (\d+)>\(\);", ctas)]
    assert all(a == b for a, b in cases)
    assert tuple(a for a, _ in cases) == kernels.REDUCE_CTAS
    assert "default: return f.template operator()<GMAX, 0>();" in ctas
    for c in range(kernels.MIN_CHANNELS, kernels.MAX_CHANNELS + 1):
        want = next(w for w in _REDUCE_WIDTHS if 6 + c <= w)
        for tile in range(1, 81):
            k = kernels.ctas_per_tile(tile)
            assert kernels.reduce_instance(c, k) == (want, k if k in kernels.REDUCE_CTAS else 0)
    for c in (kernels.MIN_CHANNELS - 1, kernels.MAX_CHANNELS + 1):
        with pytest.raises(ValueError):
            kernels.reduce_instance(c, 4)
    with pytest.raises(ValueError):
        kernels.reduce_instance(19, 0)


def test_flag_stride_matches_the_source():
    """The bytes of `stored` per instance: K, padded to whole words past 1,
    as blend_common.cuh's flag_stride, which both kernels index with."""
    src = (CSRC / "blend_common.cuh").read_text()
    assert "constexpr int flag_stride(int k) { return k == 1 ? 1 : (k + 3) & ~3; }" in src
    for k in range(1, 40):
        assert kernels.flag_stride(k) == (1 if k == 1 else (k + 3) & ~3)
    for name in ("blend_bwd.cu", "blend_reduce.cu"):
        assert "flag_stride(" in (CSRC / name).read_text(), name


def test_another_checkout_binds_by_its_own_signatures(tmp_path):
    """An earlier checkout's sources (a backward and a reduce without
    `stored`) parse to their own argument types, and a library whose reduce
    takes fewer arguments than this package's is told apart."""
    older = tmp_path / "csrc"
    older.mkdir()
    (older / "blend_reduce.cu").write_text(
        'extern "C" int blend_reduce(const float* rows, const int* emit_inst,\n'
        '    const int* emit_start, const int* emit_count, float* d_table,\n'
        '    int channels, int gaussians, int ctas, void* stream) { return 0; }\n')
    from online_lang_splatting_tpu_torch.tools import blend_ab

    parsed = kernels.entry_points(older)
    assert parsed == {"blend_reduce": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p]}
    assert kernels.entry_points() == kernels.ARGTYPES

    class Fn:
        def __init__(self, argtypes):
            self.argtypes = argtypes

    class Lib:
        pass

    lib = Lib()
    assert not blend_ab.takes_stored(lib)  # an atomic form: no reduce
    lib.blend_reduce = Fn(parsed["blend_reduce"])
    assert not blend_ab.takes_stored(lib)
    lib.blend_reduce = Fn(kernels.ARGTYPES["blend_reduce"])
    assert blend_ab.takes_stored(lib)


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


def _prep_entry(mangled: str) -> str:
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Used 64 registers, used 1 barriers, 400 bytes cmem[0]\n")


def test_ptxas_summary_names_the_preprocess_instances():
    """The preprocess kernels' instances (namespace prep, a negative
    template argument, a kernel without any), named as
    kernels.preprocess_instance_names lists them."""
    bools = {True: "1", False: "0"}
    log = "".join(
        [_prep_entry(f"_ZN4prep21preprocess_fwd_kernelIL{'in1' if d < 0 else f'i{d}'}EEEv"
                     f"NS_4ArgsE") for d in kernels.PREPROCESS_DEGREES]
        + [_prep_entry(f"_ZN4prep21preprocess_bwd_kernelIL{'in1' if d < 0 else f'i{d}'}ELb"
                       f"{bools[g]}ELb{bools[m]}EEEvNS_4ArgsE")
           for d in kernels.PREPROCESS_DEGREES for g, m in kernels.PREPROCESS_GRADS]
        + [_prep_entry("_ZN4prep24preprocess_reduce_kernelEPKfiPf")])
    names = [row["kernel"] for row in kernels.ptxas_summary(log)]
    assert names == kernels.preprocess_instance_names()
    assert names[0] == "preprocess_fwd_kernel<-1>"
    assert "preprocess_bwd_kernel<0, false, true>" in names


def test_preprocess_instances_match_the_source():
    """The degrees and gradient sets the entry points dispatch to are
    kernels.py's."""
    fwd = (CSRC / "preprocess_fwd.cu").read_text()
    bwd = (CSRC / "preprocess_bwd.cu").read_text()
    for src, fn in ((fwd, "launch_fwd"), (bwd, "launch_bwd")):
        cases = re.findall(rf"case (-?\d+): return \(int\){fn}<(-?\d+)>", src)
        assert all(a == b for a, b in cases)
        assert tuple(int(a) for a, _ in cases) == kernels.PREPROCESS_DEGREES
    launched = re.findall(r"preprocess_bwd_kernel<DEG, (true|false), (true|false)><<<", bwd)
    assert tuple((g == "true", m == "true") for g, m in launched) == kernels.PREPROCESS_GRADS

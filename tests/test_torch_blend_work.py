"""The blend's work counts and launch counters on the CPU path.

`tiled.blend_work` (the pairs the blend must evaluate and those that
composite, from which chip_smoke.py computes each kernel's bound) is held
exactly to a brute-force count: a per-pixel front-to-back walk in numpy
float32, on the ten golden scenes at tiles 16 and 32. The per-channel launch counters are
held on the CPU path, where every call is a plain-version call.
"""

import numpy as np
import pytest
import torch

from torch_helpers import t  # noqa: F401  (sets the torch thread count)

from online_lang_splatting_tpu_torch.ops.raster import api, scenes, tiled
from online_lang_splatting_tpu_torch.ops.raster import config as C


def _inputs(name, tile, f_lang=15):
    scene = scenes.SCENES[name]()
    tt = {k: torch.as_tensor(v) for k, v in scene.items() if isinstance(v, np.ndarray)}
    settings = api.RasterSettings(
        image_height=scene["height"], image_width=scene["width"],
        tanfovx=scene["tanfovx"], tanfovy=scene["tanfovy"], sh_degree=0, tile=tile)
    prep = api.project(tt["means3d"], tt["opacities"], tt["scales"], tt["quats"],
                       viewmatrix=tt["viewmatrix"], projmatrix=tt["projmatrix"],
                       settings=settings, shs=tt["shs"])
    geom, feat, binning = tiled.blend_inputs(
        prep, tt["language_features"][:, :f_lang], width=scene["width"],
        height=scene["height"], tile=tile)
    return scene, geom, feat, binning


def _brute_force_work(geom, s_gid, starts, counts, width, height, tile):
    """Walk every pixel of every tile through its instances one at a time,
    in float32 with the reference's operation order; count the pairs whose
    alpha reaches 1/255 at a pixel still live (those that composite and each
    pixel's stopping one) and those that composite."""
    geom, s_gid = geom.numpy(), s_gid.numpy()
    tiles_x = (width + tile - 1) // tile
    half, a_max = np.float32(0.5), np.float32(C.ALPHA_MAX)
    a_min, t_eps = np.float32(C.ALPHA_MIN), np.float32(C.T_EPS)
    evaluated = contributing = 0
    for tid, n in enumerate(counts.tolist()):
        if n == 0:
            continue
        ty, tx = divmod(tid, tiles_x)
        ys, xs = np.mgrid[ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile]
        keep = (xs < width) & (ys < height)
        px, py = xs[keep].astype(np.float32), ys[keep].astype(np.float32)
        T = np.ones(px.shape, np.float32)
        live = np.ones(px.shape, bool)
        for g in s_gid[starts[tid]:starts[tid] + n]:
            x, y, ca, cb, cc, op = geom[g, :6]
            dx, dy = x - px, y - py
            power = -half * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = np.minimum(a_max, op * np.exp(power))
            hit = live & ~(power > 0) & ~(alpha < a_min)
            evaluated += int(hit.sum())
            test_t = T * (np.float32(1) - alpha)
            stop = hit & (test_t < t_eps)
            comp = hit & ~stop
            contributing += int(comp.sum())
            T = np.where(comp, test_t, T)
            live &= ~stop
    return evaluated, contributing


WORK_CASES = [(tile, name) for tile in (16, 32) for name in sorted(scenes.SCENES)]


@pytest.mark.parametrize("tile,name", WORK_CASES)
def test_blend_work_matches_brute_force(tile, name):
    scene, geom, feat, b = _inputs(name, tile)
    w, h = scene["width"], scene["height"]
    got = tiled.blend_work(geom, feat, b.s_gid, b.starts, b.tile_counts,
                           width=w, height=h, tile=tile)
    ref = _brute_force_work(geom, b.s_gid, b.starts.numpy(), b.tile_counts,
                            w, h, tile)
    assert got == ref
    evaluated, contributing = got
    assert 0 < contributing <= evaluated <= int(b.s_gid.numel()) * tile * tile


def test_blend_work_does_not_count_kernel_calls():
    _, geom, feat, b = _inputs("t_cutoff", 16)
    tiled.FWD_STATS.reset()
    tiled.BWD_STATS.reset()
    tiled.blend_work(geom, feat, b.s_gid, b.starts, b.tile_counts, width=64,
                     height=48, tile=16)
    assert (tiled.FWD_STATS.plain_calls, tiled.BWD_STATS.plain_calls) == (0, 0)


def test_blend_work_stops_with_the_pixels():
    """t_cutoff's dense opaque stack stops every pixel mid-list: the pairs
    evaluated fall short of the tile ranges times their pixels, and exceed
    those that composite by at most one stopping pair per pixel."""
    scene, geom, feat, b = _inputs("t_cutoff", 16)
    w, h = scene["width"], scene["height"]
    evaluated, contributing = tiled.blend_work(
        geom, feat, b.s_gid, b.starts, b.tile_counts, width=w, height=h, tile=16)
    full = int(b.tile_counts.sum()) * 16 * 16
    assert contributing < evaluated < full
    assert evaluated - contributing <= w * h


@pytest.mark.parametrize("tile", (16, 32))
def test_blend_work_leaves_out_pairs_beyond_reach(tile):
    """huge_splats' 32 tiny splats reach a few pixels of their tiles: the
    pairs outside their 1/255 footprint are not counted, so the pairs
    evaluated fall short of every instance times its tile's in-image
    pixels although hardly any pixel stops."""
    scene, geom, feat, b = _inputs("huge_splats", tile)
    w, h = scene["width"], scene["height"]
    evaluated, contributing = tiled.blend_work(
        geom, feat, b.s_gid, b.starts, b.tile_counts, width=w, height=h, tile=tile)
    tiles_x = (w + tile - 1) // tile
    in_tile = 0
    for tid, n in enumerate(b.tile_counts.tolist()):
        ty, tx = divmod(tid, tiles_x)
        in_tile += n * (min(w, (tx + 1) * tile) - tx * tile) * (min(h, (ty + 1) * tile) - ty * tile)
    assert contributing <= evaluated <= contributing + w * h
    assert evaluated < in_tile


def test_launch_counters_by_channels_on_the_cpu_path():
    """Every CPU call is a plain-version call, counted under its channel
    count C = F_lang + 4; reset clears totals and per-channel counts."""
    scene = scenes.SCENES["alpha_clamp"]()
    w, h = scene["width"], scene["height"]
    tiled.FWD_STATS.reset()
    tiled.BWD_STATS.reset()
    calls = {15: 2, 3: 1, 0: 3}
    for f_lang, times in calls.items():
        _, geom, feat, b = _inputs("alpha_clamp", 16, f_lang)
        args = (geom, feat, b.s_gid, b.starts, b.tile_counts)
        for _ in range(times):
            fo = tiled.blend_forward(*args, width=w, height=h, tile=16)
            tiled.blend_backward(*args, torch.ones_like(fo[0]), torch.ones_like(fo[1]),
                                 fo[0], fo[1], width=w, height=h, tile=16,
                                 emission=b.emission)
    expect = {f_lang + 4: times for f_lang, times in calls.items()}
    for stats in (tiled.FWD_STATS, tiled.BWD_STATS):
        assert stats.plain_by_channels == expect
        assert stats.plain_calls == sum(calls.values())
        assert stats.launches == 0 and stats.launches_by_channels == {}
    tiled.FWD_STATS.reset()
    assert tiled.FWD_STATS.plain_calls == 0 and tiled.FWD_STATS.plain_by_channels == {}


def test_render_counts_one_call_per_direction():
    """A training render through `rasterize` counts one forward and one
    backward under its C; F_lang 0 (tracking) under C = 4."""
    tiled.FWD_STATS.reset()
    tiled.BWD_STATS.reset()
    scenes.render_scene(scenes.SCENES["huge_splats"](), "cuda", tile=32)
    scenes.render_scene(scenes.SCENES["huge_splats"](), "cuda", tile=32, lang=False)
    for stats in (tiled.FWD_STATS, tiled.BWD_STATS):
        assert stats.plain_by_channels == {19: 1, 4: 1}

"""The blend backward in the JAX form: per-instance rows summed per Gaussian
in a fixed order, and channel groups past F_lang = 60, on the CPU path.

1. The reduce kernel's plain version (`tiled.reduce_rows_plain`, the order
   of csrc/blend_reduce.cu bit for bit) against the JAX package's
   scatter-add (`.at[ids].add`, tiled.py's default reduction) and its
   emission segment sum (`_emission_segment_sum`) on the same seeded
   per-instance rows: 1e-6 of the largest sum, also with K rows per
   instance of which only those flagged in `stored` count (the others NaN).
   With K > 1 rows per instance (the CTAs of a tile) against a float32
   numpy walk in the same order: bit for bit. With `stored`, the unstored
   rows NaN and some stored values -0: finite, and bit for bit the sum of
   every row of the same workspace zero-filled (the kernel's invariant:
   skipping an exact zero changes no bit).
2. The binning's emission order (`SortedBinning.emission`) against a
   brute-force walk of the same instances: depth order, then each
   Gaussian's tiles row by row, keeping the binning's (Gaussian, tile)
   pairs; exact, on the golden scenes at tiles 8, 15, 32 and 64.
3. Channel groups: the wrapper at F_lang 61 and 124 (two launches per
   direction) against the one-pass plain versions and against the JAX
   package's tiled Pallas blend in interpret mode, on a 64x48 scene, at
   tests/test_torch_raster.py's tolerances (forward 1e-4 normalized,
   integers exact, gradients 2e-3 normalized); the groups' column ranges;
   the CUDA check takes any width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import assert_normalized, n, t

import test_torch_blend_work as work_ref
import test_torch_raster as raster_ref
from online_lang_splatting_tpu.ops.raster.tiled import _emission_segment_sum
from online_lang_splatting_tpu.ops.raster.tiled import blend_tiled as jblend_tiled
from online_lang_splatting_tpu_torch.ops.raster import api, kernels, scenes, tiled
from online_lang_splatting_tpu_torch.ops.raster.binning import EmissionOrder

CASES = [(name, tile) for name in sorted(scenes.SCENES) for tile in (8, 15, 32, 64)]


def _prep(name, tile):
    scene = scenes.SCENES[name]()
    tt = {k: torch.as_tensor(v) for k, v in scene.items() if isinstance(v, np.ndarray)}
    settings = api.RasterSettings(
        image_height=scene["height"], image_width=scene["width"],
        tanfovx=scene["tanfovx"], tanfovy=scene["tanfovy"], sh_degree=0, tile=tile)
    return api.project(tt["means3d"], tt["opacities"], tt["scales"], tt["quats"],
                       viewmatrix=tt["viewmatrix"], projmatrix=tt["projmatrix"],
                       settings=settings, shs=tt["shs"])


def _rows(binning, values: int, ctas: int = 1, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(binning.s_gid.shape[0], ctas, values)).astype(np.float32)


def _all_stored(rows: np.ndarray) -> np.ndarray:
    """`stored` flags with every slot of rows (S, K, G) set."""
    return np.ones((rows.shape[0], kernels.flag_stride(rows.shape[1])), np.uint8)


def _walk(rows: np.ndarray, emission, p: int) -> np.ndarray:
    """The sums in float32 numpy, in the reduce's order as the earlier
    workspace form took it: every one of an instance's K rows, left to
    right, then a Gaussian's instances in emission order onto zero."""
    inst, start, count = (n(x) for x in emission)
    want = np.zeros((p, rows.shape[2]), np.float32)
    for gid in range(p):
        acc = np.zeros(rows.shape[2], np.float32)
        for e in range(start[gid], start[gid] + count[gid]):
            row = rows[inst[e], 0].copy()
            for k in range(1, rows.shape[1]):
                row = row + rows[inst[e], k]
            acc = acc + row
        want[gid] = acc
    return want


@pytest.mark.parametrize("name,tile", CASES)
def test_fixed_order_reduction_matches_jax(name, tile):
    scene, geom, feat, b = work_ref._inputs(name, tile)
    p, g = geom.shape[0], 6 + feat.shape[1]
    rows = _rows(b, g, seed=tile)[:, 0]
    got = n(tiled.reduce_rows_plain(t(rows)[:, None], b.emission, p,
                                    t(_all_stored(rows[:, None]))))
    scatter = np.asarray(jnp.zeros((p, g), jnp.float32).at[jnp.asarray(n(b.s_gid))].add(
        jnp.asarray(rows)))
    s_emit = np.argsort(n(b.emission.inst))  # emission index per sorted instance
    tiles = -(-scene["width"] // tile) * -(-scene["height"] // tile)
    segment = np.asarray(_emission_segment_sum(
        jnp.asarray(rows), jnp.asarray(s_emit.astype(np.int32)),
        jnp.asarray(n(b.emission.start)), jnp.asarray(n(b.emission.count)), p, tiles))
    scale = np.abs(scatter).max()
    assert scale > 0
    assert np.abs(got - scatter).max() <= 1e-6 * scale
    assert np.abs(got - segment).max() <= 1e-6 * scale
    # Gaussians without an instance get zero rows.
    assert not got[n(b.emission.count) == 0].any()


@pytest.mark.parametrize("ctas", (1, 4, 16))
def test_reduction_adds_the_ctas_then_the_instances_in_order(ctas):
    _, geom, feat, b = work_ref._inputs("many_contrib", 32)
    p, g = geom.shape[0], 6 + feat.shape[1]
    rows = _rows(b, g, ctas, seed=ctas)
    got = n(tiled.reduce_rows_plain(t(rows), b.emission, p, t(_all_stored(rows))))
    np.testing.assert_array_equal(got, _walk(rows, b.emission, p))


def _stored_rows(rows: np.ndarray, seed: int):
    """Random `stored` flags (S, flag_stride(K)) uint8 for rows (S, K, G),
    with the rows' unstored slots set to NaN and zero-filled, and a few
    stored values set to -0."""
    s, k, g = rows.shape
    rng = np.random.default_rng(seed)
    flags = np.zeros((s, kernels.flag_stride(k)), np.uint8)
    flags[:, :k] = rng.uniform(size=(s, k)) < 0.6
    rows = rows.copy()
    rows[rng.uniform(size=rows.shape) < 0.05] = -0.0
    on = flags[:, :k, None].astype(bool)
    return flags, np.where(on, rows, np.float32(np.nan)), np.where(on, rows, np.float32(0.0))


@pytest.mark.parametrize("name,tile", CASES)
def test_fixed_order_reduction_with_stored_matches_jax(name, tile):
    """K = ctas_per_tile(tile) rows per instance, only the stored ones
    counted: the JAX scatter-add and emission segment sum of each
    instance's stored rows (summed in k order) at 1e-6 of the largest sum."""
    scene, geom, feat, b = work_ref._inputs(name, tile)
    p, g = geom.shape[0], 6 + feat.shape[1]
    k = kernels.ctas_per_tile(tile)
    flags, nan_rows, zero_rows = _stored_rows(_rows(b, g, k, seed=tile), seed=tile)
    got = n(tiled.reduce_rows_plain(t(nan_rows), b.emission, p, t(flags)))
    per_inst = zero_rows[:, 0]
    for q in range(1, k):
        per_inst = per_inst + zero_rows[:, q]
    scatter = np.asarray(jnp.zeros((p, g), jnp.float32).at[jnp.asarray(n(b.s_gid))].add(
        jnp.asarray(per_inst)))
    s_emit = np.argsort(n(b.emission.inst))
    tiles = -(-scene["width"] // tile) * -(-scene["height"] // tile)
    segment = np.asarray(_emission_segment_sum(
        jnp.asarray(per_inst), jnp.asarray(s_emit.astype(np.int32)),
        jnp.asarray(n(b.emission.start)), jnp.asarray(n(b.emission.count)), p, tiles))
    scale = np.abs(scatter).max()
    assert scale > 0 and np.isfinite(got).all()
    assert np.abs(got - scatter).max() <= 1e-6 * scale
    assert np.abs(got - segment).max() <= 1e-6 * scale


@pytest.mark.parametrize("ctas", (1, 4, 16))
def test_reduction_skips_unstored_rows_bit_for_bit(ctas):
    """NaN in every unstored slot: the sums are finite and bit-equal to the
    old order (all K rows, left to right) on the zero-filled workspace."""
    _, geom, feat, b = work_ref._inputs("many_contrib", 32)
    p, g = geom.shape[0], 6 + feat.shape[1]
    flags, nan_rows, zero_rows = _stored_rows(_rows(b, g, ctas, seed=10 + ctas), seed=ctas)
    got = n(tiled.reduce_rows_plain(t(nan_rows), b.emission, p, t(flags)))
    old = _walk(zero_rows, b.emission, p)
    assert np.isfinite(got).all() and float(np.abs(old).max()) > 0
    np.testing.assert_array_equal(got.view(np.int32), old.view(np.int32))
    # Every slot stored: the old order itself, bit for bit.
    again = n(tiled.reduce_rows_plain(t(zero_rows), b.emission, p, t(_all_stored(zero_rows))))
    np.testing.assert_array_equal(again.view(np.int32), old.view(np.int32))


def _brute_force_emission(prep, s_gid, s_tile, p: int, tiles_x: int) -> EmissionOrder:
    """Walk the Gaussians in depth order (those touching no tile last, ties
    by id) and each one's tile rect row by row, keeping the (Gaussian,
    tile) pairs the binning kept."""
    depth = np.where(n(prep.tiles_touched) > 0, n(prep.depth), np.inf)
    where = {(int(gid), int(tile)): i for i, (gid, tile) in enumerate(zip(s_gid, s_tile))}
    rmin, rmax = n(prep.rect_min), n(prep.rect_max)
    inst, start, count = [], np.zeros(p, np.int32), np.zeros(p, np.int32)
    for gid in np.argsort(depth, kind="stable"):
        start[gid] = len(inst)
        if n(prep.tiles_touched)[gid] > 0:
            for ty in range(rmin[gid, 1], rmax[gid, 1]):
                for tx in range(rmin[gid, 0], rmax[gid, 0]):
                    i = where.get((int(gid), ty * tiles_x + tx))
                    if i is not None:
                        inst.append(i)
        count[gid] = len(inst) - start[gid]
    return EmissionOrder(np.asarray(inst, np.int32), start, count)


@pytest.mark.parametrize("name,tile", CASES)
def test_emission_order_matches_a_brute_force_walk(name, tile):
    scene, geom, _, b = work_ref._inputs(name, tile)
    prep = _prep(name, tile)
    tiles_x = -(-scene["width"] // tile)
    want = _brute_force_emission(prep, n(b.s_gid), n(b.s_tile), geom.shape[0], tiles_x)
    got = EmissionOrder(*(n(x) for x in b.emission))
    assert all(x.dtype == torch.int32 for x in b.emission)
    np.testing.assert_array_equal(got.inst, want.inst)
    np.testing.assert_array_equal(got.count, want.count)
    live = want.count > 0
    np.testing.assert_array_equal(got.start[live], want.start[live])
    # A permutation of the sorted instances; each Gaussian's run is its own,
    # in increasing tile id.
    assert sorted(got.inst.tolist()) == list(range(b.s_gid.shape[0]))
    s_gid, s_tile = n(b.s_gid), n(b.s_tile)
    for gid in np.flatnonzero(live):
        run = got.inst[got.start[gid]:got.start[gid] + got.count[gid]]
        assert (s_gid[run] == gid).all() and (np.diff(s_tile[run]) > 0).all()


@pytest.mark.parametrize("channels", (4, 19, 64, 65, 127, 128, 129, 256, 300))
def test_channel_groups_cover_the_columns(channels):
    groups = tiled.channel_groups(channels)
    assert groups[0][0] == 0 and groups[-1][1] == channels
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(groups, groups[1:]))
    widths = [b - a for a, b in groups]
    assert len(groups) == -(-channels // kernels.MAX_CHANNELS)
    assert max(widths) <= kernels.MAX_CHANNELS and max(widths) - min(widths) <= 1
    assert min(widths) >= (32 if channels > kernels.MAX_CHANNELS else kernels.MIN_CHANNELS)
    for w in widths:  # every group has a compiled instance
        kernels.instance_of(w)


@pytest.mark.parametrize("channels,tile", [(65, 16), (128, 32), (256, 64), (1028, 15)])
def test_cuda_check_takes_any_width(channels, tile):
    tiled._check_cuda_inputs({}, channels, tile)
    with pytest.raises(ValueError, match="one launch"):
        kernels.instance_of(channels)


@pytest.mark.parametrize("f_lang", (61, 124))
def test_channel_groups_match_one_pass_and_jax(f_lang):
    sc = raster_ref._scene(40, 64, 48, seed=f_lang, sh_degree=0)
    sc["lang"] = np.random.default_rng(200 + f_lang).normal(size=(40, f_lang)).astype(np.float32)
    tile = 16
    prep = raster_ref._jax_prep(sc, tile)
    tiled.FWD_STATS.reset()
    tiled.BWD_STATS.reset()
    tiled.REDUCE_STATS.reset()
    got, gg = raster_ref._torch_blend(prep, sc["lang"], sc, tile, stats=True)
    widths = [b - a for a, b in tiled.channel_groups(f_lang + 4)]
    want = {w: widths.count(w) for w in widths}
    for stats in (tiled.FWD_STATS, tiled.BWD_STATS, tiled.REDUCE_STATS):
        assert stats.plain_by_channels == want
    ref, rg = raster_ref._jax_blend(prep, sc["lang"], sc, tile, jblend_tiled)
    raster_ref._compare_blend(got, ref, gg, rg, what=f"F {f_lang} groups vs JAX tiled")
    assert int(n(got.n_touched).sum()) > 0

    # The same inputs through the one-pass plain versions.
    p_t = raster_ref._prep_to_torch(prep)
    geom, feat, b = tiled.blend_inputs(p_t, t(sc["lang"]), width=64, height=48, tile=tile)
    args = (geom, feat, b.s_gid, b.starts, b.tile_counts)
    kw = dict(width=64, height=48, tile=tile)
    grouped = tiled.blend_forward(*args, **kw)
    one = tiled.blend_forward_plain(*args, **kw)
    assert_normalized(grouped[0], one[0], 1e-4, "feat_img")
    for a, c in zip(grouped[1:], one[1:]):
        assert torch.equal(a, c)
    gen = torch.Generator().manual_seed(f_lang)
    g_feat = torch.randn(one[0].shape, generator=gen)
    g_t = torch.randn(one[1].shape, generator=gen)
    dg, df = tiled.blend_backward(*args, g_feat, g_t, one[0], one[1], emission=b.emission, **kw)
    rg_geom, rg_feat = tiled.blend_backward_plain(*args, g_feat, g_t, one[0], one[1], **kw)
    assert float(dg.abs().max()) > 0
    assert_normalized(dg, rg_geom, 2e-3, "d_geom")
    assert_normalized(df, rg_feat, 2e-3, "d_feat")


def test_backproject_sample_breaks_ties_as_jax_top_k():
    """The map init's point draw picks the n smallest scores with ties by
    pixel index, as jax.lax.top_k does: the same pixels in the same order
    on every run, however many draws tie."""
    import jax

    from online_lang_splatting_tpu_torch.slam import backend

    h, w, n_target = 24, 32, 300
    rng = np.random.default_rng(5)
    uniform = (np.floor(rng.uniform(size=h * w) * 16) / 16).astype(np.float32)  # many ties
    depth = np.ones((h, w), np.float32)
    depth[:2] = 0.0
    image = np.stack([np.arange(h * w, dtype=np.float32).reshape(h, w) / (h * w)] * 3)
    intr = (30.0, 30.0, w / 2, h / 2)
    got = backend.backproject_sample(t(image), t(depth), torch.eye(4), intr, t(uniform),
                                     n_target)
    score = np.where(depth.reshape(-1) > 0, uniform, 2.0).astype(np.float32)
    idx = np.asarray(jax.lax.top_k(-jnp.asarray(score), n_target)[1])
    np.testing.assert_array_equal(n(got[1])[:, 0], image[0].reshape(-1)[idx])
    np.testing.assert_array_equal(n(got[2]), score[idx] < 1.5)


def test_hr_head_upsample_is_the_transposed_convolution():
    """The HR head's 2x upsample, four 2x2 convolutions interleaved (forward
    convolutions sum in a fixed order on the card), equals
    ConvTranspose2d(k=4, s=2, p=1) with the same parameters (float64)."""
    from online_lang_splatting_tpu_torch.models.hr_net import PhaseConvTranspose2d

    m = PhaseConvTranspose2d(5, 3).double()
    ref = torch.nn.ConvTranspose2d(5, 3, 4, stride=2, padding=1).double()
    ref.load_state_dict(m.state_dict())
    x = torch.randn((2, 5, 6, 7), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_allclose(n(m(x)), n(ref(x)), rtol=0, atol=1e-12)

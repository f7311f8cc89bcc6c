"""The blend kernels' domain on the CPU: any tile, any language width.

1. The plain blend (the CPU path of both CUDA kernels) against the JAX
   package's tiled Pallas blend in interpret mode and its oracle at tiles
   8, 15, 24, 48 and 64 x F_lang 0, 1, 8, 23 and 60, on scenes of 32x32 to
   80x48: forward integers exact, images 1e-4 normalized, gradients 2e-3
   normalized (tests/test_torch_raster.py's tolerances).
2. `tiled.blend_work` at the new tiles against the brute-force walk of
   tests/test_torch_blend_work.py (exact).
3. The wrapper's domain: any C = F_lang + 4 >= 4 and any tile >= 1 are
   taken (past 64 in channel groups), C = 3 and tile 0 are refused by the
   check alone, and each C up to 64 maps to the compiled instance that
   runs it.
4. The slice: smoke.yaml's first frames as a Replica-v2 tree with 23-d
   label files (`language.labels_from_file`, `lang_code_size: 23`) and
   `raster_tile: 24`. Both packages' datasets read the same frames and
   labels (exact); tracking_run (pose atol 1e-4, as tests/test_torch_slam.py)
   and one mapping iteration on the files' supervision (params rtol 1e-4,
   atol 1e-6, as tests/test_torch_slam.py; the language params atol 2e-3
   of tests/test_torch_language_slam.py) against the JAX package's, with
   the language map rendered after it by the port's plain blend and by the
   JAX tiled Pallas blend at C = 27, tile 24 (1e-4 normalized); and the
   port's 4-frame run on the tree, whose keyframe supervision is the files'
   codes and whose renders go through the blend at C = 27.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_helpers import assert_normalized, jax_params_aux, map_from_frame, n, t

import test_torch_blend_work as work_ref
import test_torch_raster as raster_ref
from online_lang_splatting_tpu.models import gaussians as JG
from online_lang_splatting_tpu.ops import graphics as jgraphics
from online_lang_splatting_tpu.ops.raster import RasterSettings as JSettings
from online_lang_splatting_tpu.ops.raster.oracle import blend_oracle as jblend_oracle
from online_lang_splatting_tpu.ops.raster.tiled import blend_tiled as jblend_tiled
from online_lang_splatting_tpu.slam import backend as jbackend
from online_lang_splatting_tpu.slam import camera as jcamera
from online_lang_splatting_tpu.slam import datasets as jdatasets
from online_lang_splatting_tpu.slam import frontend as jfrontend
from online_lang_splatting_tpu.slam import renderer as jrenderer
from online_lang_splatting_tpu_torch.convert import gaussians_from_numpy
from online_lang_splatting_tpu_torch.models import gaussians as G
from online_lang_splatting_tpu_torch.ops import graphics
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings, kernels, tiled
from online_lang_splatting_tpu_torch.slam import backend, datasets, frontend, renderer
from online_lang_splatting_tpu_torch.slam.config import load_config

SMOKE = "configs/synthetic/smoke.yaml"
TILES = (8, 15, 24, 48, 64)
F_LANG = (0, 1, 8, 23, 60)
# (width, height) per tile: 16 does not divide 24, 48 splits into 3x3
# squares, 64 into 4x4; the image edge cuts the last tiles.
SIZES = {8: (32, 32), 15: (64, 48), 24: (80, 48), 48: (80, 48), 64: (80, 48)}
SLICE_F, SLICE_TILE, SLICE_FRAMES = 23, 24, 4


@pytest.mark.parametrize("f_lang", F_LANG)
@pytest.mark.parametrize("tile", TILES)
def test_plain_blend_vs_jax_tiled_and_oracle(tile, f_lang):
    width, height = SIZES[tile]
    sc = raster_ref._scene(40, width, height, seed=tile + f_lang, sh_degree=0)
    sc["lang"] = np.random.default_rng(100 + f_lang).normal(size=(40, f_lang)).astype(np.float32)
    prep = raster_ref._jax_prep(sc, tile)
    ref_t, rg_t = raster_ref._jax_blend(prep, sc["lang"], sc, tile, jblend_tiled)
    ref_o, rg_o = raster_ref._jax_blend(prep, sc["lang"], sc, tile, jblend_oracle)
    got, gg = raster_ref._torch_blend(prep, sc["lang"], sc, tile, stats=True)
    assert int(n(got.n_touched).sum()) > 0
    raster_ref._compare_blend(got, ref_t, gg, rg_t, what=f"tile {tile} F {f_lang} vs tiled")
    raster_ref._compare_blend(got, ref_o, gg, rg_o, what=f"tile {tile} F {f_lang} vs oracle")


@pytest.mark.parametrize("tile", (8, 24, 48, 64))
def test_blend_work_at_any_tile(tile):
    scene, geom, feat, binning = work_ref._inputs("huge_splats", tile)
    w, h = scene["width"], scene["height"]
    got = tiled.blend_work(geom, feat, binning.s_gid, binning.starts, binning.tile_counts,
                           width=w, height=h, tile=tile)
    ref = work_ref._brute_force_work(geom, binning.s_gid, binning.starts,
                                     binning.tile_counts, w, h, tile)
    assert got == ref and got[1] > 0


@pytest.mark.parametrize("channels,tile", [(4, 1), (4, 15), (5, 24), (19, 32), (27, 24),
                                           (27, 64), (36, 48), (64, 64), (64, 1000)])
def test_wrapper_takes_the_domain(channels, tile):
    tiled._check_cuda_inputs({}, channels, tile)
    width, exact = kernels.instance_of(channels)
    assert width >= channels and exact == (channels in kernels.EXACT_WIDTHS)
    assert width in (kernels.EXACT_WIDTHS if exact else kernels.PADDED_WIDTHS)


@pytest.mark.parametrize("channels,tile,what", [
    (3, 16, "at least 4 channels (colour, depth), got 3"),
    (0, 16, "at least 4 channels (colour, depth), got 0"),
    (27, 0, "tiles >= 1, got 0")])
def test_wrapper_refuses_outside_the_domain(channels, tile, what):
    # No tensor is given: the domain alone decides.
    with pytest.raises(ValueError, match=what.replace("(", r"\(").replace(")", r"\)")):
        tiled._check_cuda_inputs({}, channels, tile)


def test_cpu_tensors_take_the_plain_path_past_the_domain():
    """Past C = 64 a CPU tensor renders in the kernels' channel groups, each
    group through the plain version, and equals the one-pass plain
    version."""
    scene, geom, _, binning = work_ref._inputs("alpha_clamp", 16)
    feat = torch.randn((geom.shape[0], 66), generator=torch.Generator().manual_seed(0))
    args = (geom, feat, binning.s_gid, binning.starts, binning.tile_counts)
    kw = dict(width=scene["width"], height=scene["height"], tile=16)
    tiled.FWD_STATS.reset()
    out = tiled.blend_forward(*args, **kw)
    assert out[0].shape[0] == 66 and tiled.FWD_STATS.plain_by_channels == {33: 2}
    one = tiled.blend_forward_plain(*args, **kw)
    assert_normalized(out[0], one[0], 1e-4, "feat_img")
    assert all(torch.equal(a, b) for a, b in zip(out[1:], one[1:]))


# ---------------------------------------------------------------------------
# The slice: 23-d labels from file at tile 24


def _smooth_codes(rng, f, hw=192):
    """(f, hw, hw) float32 codes that vary smoothly over the image, so a
    few mapping iterations can move a map toward them."""
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    a = rng.normal(size=(f, 3)) * 0.3
    return (a[:, :1, None] * np.cos(3 * xx + a[:, 1:2, None])
            + a[:, 2:3, None] * yy).astype(np.float32)


@pytest.fixture(scope="module")
def pca_tree(tmp_path_factory):
    """smoke.yaml's first frames as a Replica-v2 tree (8-bit colour, 16-bit
    depth at depth_scale 1000, traj_w_c.txt) with one (23, 192, 192)
    `*_ld.npy` label per frame, and the config that reads them."""
    root = tmp_path_factory.mktemp("pca_slice")
    cfg = load_config(SMOKE)
    ds = datasets.SyntheticDataset(cfg)
    for sub in ("rgb", "depth", "labels"):
        (root / sub).mkdir()
    rng = np.random.default_rng(23)
    lines = []
    for i in range(SLICE_FRAMES):
        color, depth, pose, _, _ = ds[i]
        Image.fromarray((color.transpose(1, 2, 0) * 255).round().astype(np.uint8)).save(
            root / "rgb" / f"rgb_{i}.png")
        Image.fromarray(np.clip(depth * 1000, 0, 65535).round().astype(np.uint16)).save(
            root / "depth" / f"depth_{i}.png")
        lines.append(" ".join(f"{v:.9f}" for v in pose.reshape(-1)))
        np.save(root / "labels" / f"{i:04d}_ld.npy", _smooth_codes(rng, SLICE_F))
    (root / "traj_w_c.txt").write_text("\n".join(lines) + "\n")
    cfg["Dataset"].update(type="replicav2", dataset_path=str(root), prefetch=False)
    cfg["Dataset"]["Calibration"]["depth_scale"] = 1000.0
    cfg["raster_tile"] = SLICE_TILE
    cfg["language"].update(labels_from_file=True, lang_code_size=SLICE_F,
                           lang_label_path=str(root / "labels"), allow_zero_supervision=False)
    cfg["Training"].update(init_itr_num=15, mapping_itr_num=5, tracking_itr_num=10)
    return root, cfg


def test_slice_datasets_read_the_label_files(pca_tree):
    _, cfg = pca_tree
    ds, jds = datasets.load_dataset(cfg), jdatasets.load_dataset(cfg)
    assert len(ds) == len(jds) == SLICE_FRAMES
    for i in range(SLICE_FRAMES):
        got, ref = ds[i], jds[i]
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert got[3].shape == (SLICE_F, 192, 192)


def _settings(ds, backend_name):
    kw = dict(image_height=ds.height, image_width=ds.width, tanfovx=np.tan(ds.fovx / 2),
              tanfovy=np.tan(ds.fovy / 2), sh_degree=0, tile=SLICE_TILE)
    if backend_name == "jax":
        return JSettings(backend="oracle", **kw)
    return RasterSettings(backend="cuda", **kw)


def _proj(ds):
    return n(graphics.projection_matrix(0.01, 100.0, ds.cx, ds.cy, ds.fx, ds.fy,
                                        ds.width, ds.height))


def test_slice_tracking_matches_jax(pca_tree):
    _, cfg = pca_tree
    ds = datasets.load_dataset(cfg)
    proj = _proj(ds)
    np.testing.assert_array_equal(proj, n(jgraphics.projection_matrix(
        0.01, 100.0, ds.cx, ds.cy, ds.fx, ds.fy, ds.width, ds.height)))
    tree = map_from_frame(ds)
    jp, ja = jax_params_aux(tree)
    tp, ta, _ = gaussians_from_numpy(tree)
    color, depth, _, _, _ = ds[1]
    w2c0 = ds[0][2]
    gmask = n(jcamera._grad_mask_device(jnp.asarray(color), False, 32, 32, jnp.float32(4.0)))
    tr = cfg["Training"]
    lrs = (np.float32(tr["lr"]["cam_trans_delta"]), np.float32(tr["lr"]["cam_rot_delta"]),
           np.float32(0.01))
    ref = jfrontend.tracking_run(
        jrenderer.activate(jp, ja.active), jnp.asarray(w2c0), jnp.asarray(proj),
        jnp.asarray(color), jnp.asarray(depth)[None], jnp.asarray(gmask), np.float32(0.0),
        np.float32(0.0), lrs, np.float32(0.0), np.float32(1.0), settings=_settings(ds, "jax"),
        max_iters=10, rgb_threshold=tr["rgb_boundary_threshold"])
    got = frontend.tracking_run(
        renderer.activate(tp, ta.active), t(w2c0), t(proj), t(color), t(depth)[None],
        t(gmask), 0.0, 0.0, lrs, settings=_settings(ds, "port"), max_iters=10,
        rgb_threshold=tr["rgb_boundary_threshold"])
    assert got[3] == int(ref[3]) == 10
    np.testing.assert_allclose(n(got[0]), n(ref[0]), atol=1e-4)
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-4)
    np.testing.assert_array_equal(n(got[6]), n(ref[6]))
    assert np.abs(n(got[0]) - w2c0).max() > 1e-3  # the pose did move


def test_slice_mapping_iteration_matches_jax(pca_tree):
    """One mapping iteration on two keyframes whose supervision is the
    label files' 23-d codes, then the language map rendered from the
    updated map: the port's plain blend vs the JAX tiled Pallas blend at
    C = 27, tile 24."""
    _, cfg = pca_tree
    ds = datasets.load_dataset(cfg)
    proj = _proj(ds)
    rng = np.random.default_rng(7)
    tree = map_from_frame(ds, seed=1)
    tree["language"] = (rng.normal(size=(tree["xyz"].shape[0], SLICE_F)) * 0.1).astype(np.float32)
    jp, ja = jax_params_aux(tree)
    jo = JG.init_adam(jp)
    tp, ta, to = gaussians_from_numpy(tree)
    frames = [ds[i] for i in (0, 2)]
    s = len(frames)
    slot_r = np.stack([f[2][:3, :3] for f in frames]).astype(np.float32)
    slot_t = (np.stack([f[2][:3, 3] for f in frames])
              + rng.normal(size=(s, 3)) * 0.003).astype(np.float32)
    zs = np.zeros(s, np.float32)
    images = np.stack([f[0] for f in frames])
    depths = np.stack([f[1][None] for f in frames])
    langs = np.stack([f[3] for f in frames])
    assert langs.shape == (s, SLICE_F, 192, 192)
    valid = np.ones(s, bool)
    pose_opt = np.array([False, True])
    exp_opt = np.array([True, True])
    pm = tuple(np.zeros(sh, np.float32) for sh in ((s, 3), (s, 3), (s,), (s,)))
    pv = tuple(np.full(sh, 1e-6, np.float32) for sh in ((s, 3), (s, 3), (s,), (s,)))
    pt = np.full(s, 2.0, np.float32)
    lrs = [np.float32(x) for x in (1.6e-4, 2.5e-3, 1.25e-4, 1e-3, 1e-3, 5e-2, 2.5e-3)]
    ref = jbackend.mapping_iteration(
        jp, jo, ja, jnp.asarray(proj), *map(jnp.asarray, (slot_r, slot_t, zs, zs)),
        tuple(map(jnp.asarray, pm)), tuple(map(jnp.asarray, pv)), jnp.asarray(pt),
        *map(jnp.asarray, (images, depths, langs, valid, valid, pose_opt, exp_opt)),
        JG.LearningRates(*map(jnp.asarray, lrs)), jnp.float32(1.0),
        settings=_settings(ds, "jax"), n_slots=s, init_mode=False)
    got = backend.mapping_iteration(
        tp, to, ta, t(proj), *map(t, (slot_r, slot_t, zs, zs)),
        tuple(map(t, pm)), tuple(map(t, pv)), t(pt), list(t(images)), list(t(depths)),
        list(t(langs)), list(valid), list(valid), pose_opt, t(exp_opt),
        G.LearningRates(*map(t, lrs)), 1.0, settings=_settings(ds, "port"), init_mode=False)
    for f, g, e in zip(JG.GaussianParams._fields, got[0], ref[0]):
        if f == "language":
            np.testing.assert_allclose(n(g), n(e), atol=2e-3, err_msg=f)
        else:
            np.testing.assert_allclose(n(g), n(e), rtol=1e-4, atol=1e-6, err_msg=f"params.{f}")
    np.testing.assert_array_equal(n(got[8]), n(ref[8]))
    np.testing.assert_allclose(float(got[9]), float(ref[9]), rtol=1e-4)
    assert np.abs(n(ref[0].language) - tree["language"]).max() > 1e-4  # the codes moved

    # The language map of keyframe 2 from the updated map, through each
    # package's tiled blend at C = 27, tile 24.
    view = frames[1][2]
    jset = _settings(ds, "jax")._replace(backend="tpu")
    jout = jrenderer.render(jrenderer.activate(ref[0], ja.active), jnp.asarray(view),
                            jnp.asarray(proj), jset)
    tiled.FWD_STATS.reset()
    tout = renderer.render(renderer.activate(got[0], ta.active), t(view), t(proj),
                           _settings(ds, "port"))
    assert tiled.FWD_STATS.plain_by_channels == {SLICE_F + 4: 1}
    assert tout.language.shape == (SLICE_F, ds.height, ds.width)
    assert_normalized(tout.language, jout.language, 1e-4, "language map")
    np.testing.assert_array_equal(n(tout.n_touched), n(jout.n_touched))


def test_slice_port_run_on_the_label_files(pca_tree, tmp_path, monkeypatch):
    """slam_torch.py --eval on the tree: the keyframes' supervision is the
    files' codes, every render at C = 27 goes through the blend, and the
    rendered language maps moved toward the supervision."""
    import slam_torch
    from online_lang_splatting_tpu_torch.models import checkpoints

    root, cfg = pca_tree
    cfg = json.loads(json.dumps(cfg))
    cfg["Results"].update(save_dir=str(tmp_path / "results"), color_refinement_iters=2)
    (tmp_path / "pca.yaml").write_text(json.dumps(cfg))
    # The labels come from file: no extractor (ConvNeXt-L) is needed.
    monkeypatch.setattr(checkpoints, "load_extractor_from_dir", lambda *a, **k: (None, None))
    tiled.FWD_STATS.reset()
    tiled.BWD_STATS.reset()
    slam = slam_torch.main(["--config", str(tmp_path / "pca.yaml"), "--eval",
                            "--max-frames", str(SLICE_FRAMES), "--device", "cpu"])
    be, fe = slam.backend, slam.frontend
    assert be.lang_dim == SLICE_F and slam.settings.tile == SLICE_TILE
    assert tiled.FWD_STATS.plain_by_channels.get(SLICE_F + 4, 0) > 0
    assert tiled.BWD_STATS.plain_by_channels.get(SLICE_F + 4, 0) > 0
    assert len(fe.kf_indices) >= 2
    inputs = renderer.activate(be.params, be.aux.active)
    for kf in fe.kf_indices:
        sup = np.load(root / "labels" / f"{kf:04d}_ld.npy")
        np.testing.assert_array_equal(n(be.frame_stack.langs[kf]), sup)
        out = renderer.render(inputs, t(be.viewpoints[kf].world_view_transform), slam.proj,
                              slam.settings)
        full = backend.resize_bilinear(t(sup), (slam.settings.image_height,
                                                slam.settings.image_width))
        l1 = float(torch.abs(out.language - full).mean())
        assert l1 < float(full.abs().mean()), (kf, l1)  # below the zero map's L1
    assert np.isfinite(slam.metrics["before_opt"]["ate_rmse"])

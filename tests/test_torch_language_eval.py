"""Port parity of the evaluation stack: CLIP relevancy, SSIM / MS-SSIM,
the LERF scoring (blur, mode filter, activate_stream, localization,
evaluate_scene and its multilevel form, annotations), the synthetic
scene's semantics and the rendering / trajectory evaluation.

Tolerances: relevancy 1e-6 with labels exact, SSIM / MS-SSIM 1e-5, the box
blur 1e-5 against OpenCV, the polygon fill and labelme masks exact against
OpenCV, IoUs 1e-6 and localization hits exact,
gt_semantics exact; the rendering evaluation 1e-4 (the JAX side renders
through its dense oracle, the port through the plain blend).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import assert_normalized, jax_params_aux, map_from_frame, n, t

from online_lang_splatting_tpu.eval import lerf_eval as jlerf
from online_lang_splatting_tpu.eval import relevancy as jrel
from online_lang_splatting_tpu.eval import synthetic_miou as jsyn
from online_lang_splatting_tpu.ops import losses as jlosses
from online_lang_splatting_tpu.ops.raster import RasterSettings as JSettings
from online_lang_splatting_tpu.slam import datasets as jdatasets
from online_lang_splatting_tpu.slam import evaluation as jevaluation
from online_lang_splatting_tpu.slam.config import load_config as jload_config
from online_lang_splatting_tpu_torch.convert import gaussians_from_numpy
from online_lang_splatting_tpu_torch.eval import lerf_eval, relevancy, synthetic_miou
from online_lang_splatting_tpu_torch.ops import graphics, losses
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings
from online_lang_splatting_tpu_torch.slam import datasets, evaluation
from online_lang_splatting_tpu_torch.slam.config import load_config

SMOKE = "configs/synthetic/smoke.yaml"


def _unit(rng, n_rows, dim):
    x = rng.normal(size=(n_rows, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _relevancies(rng, n_pos=5, dim=64):
    pos, neg = _unit(rng, n_pos, dim), _unit(rng, 4, dim)
    return (relevancy.CLIPRelevancy(pos_embeds=pos, neg_embeds=neg, device="cpu"),
            jrel.CLIPRelevancy(pos_embeds=pos, neg_embeds=neg))


def test_relevancy_matches_jax():
    rng = np.random.default_rng(0)
    rel, jr = _relevancies(rng)
    embed = _unit(rng, 500, 64) + rng.normal(size=(500, 64)).astype(np.float32) * 0.3
    assert_normalized(rel.relevancy_all(t(embed)), jr.relevancy_all(jnp.asarray(embed)), 1e-6)
    for pid in (0, 3):
        assert_normalized(rel.get_relevancy(t(embed), pid),
                          jr.get_relevancy(jnp.asarray(embed), pid), 1e-6, f"prompt {pid}")
    sem = embed.reshape(2, 10, 25, 64)
    assert_normalized(rel.get_max_across(t(sem)), jr.get_max_across(jnp.asarray(sem)), 1e-6)


@pytest.mark.parametrize("with_negatives", [False, True])
def test_semantic_map_matches_jax(with_negatives):
    rng = np.random.default_rng(1)
    labels = ["wall", "floor", "rug"]
    table = {k: v for k, v in zip(labels + list(relevancy.NEGATIVES), _unit(rng, 7, 32))}
    rel = relevancy.CLIPRelevancy(embed_table=table, device="cpu")
    jr = jrel.CLIPRelevancy(embed_table=table)
    rel.set_semantics(labels)
    jr.set_semantics(labels)
    # Points near each class and near each negative.
    base = np.stack([table[k] for k in table])
    sem = (base[rng.integers(0, 7, 300)] + rng.normal(size=(300, 32)) * 0.2).astype(np.float32)
    sem = sem.reshape(1, 15, 20, 32)
    got = rel.get_semantic_map(t(sem), with_negatives=with_negatives)
    ref = jr.get_semantic_map(jnp.asarray(sem), with_negatives=with_negatives)
    np.testing.assert_array_equal(n(got), n(ref))
    assert (n(got) == -1).any() == with_negatives


@pytest.mark.parametrize("shape", [(3, 64, 96), (3, 30, 40), (1, 200, 180)])
def test_ssim_and_ms_ssim_match_jax(shape):
    rng = np.random.default_rng(2)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(size=shape) * 0.1, 0, 1).astype(np.float32)
    assert_normalized(losses.ssim(t(a), t(b)), jlosses.ssim(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    assert_normalized(losses.ms_ssim(t(a), t(b)),
                      jlosses.ms_ssim(jnp.asarray(a), jnp.asarray(b)), 1e-5)


def test_box_blur_and_mode_smooth_match_opencv():
    """The port's convolutions against the JAX package's cv2.filter2D and
    cv2.boxFilter calls, odd and even window sizes."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(64, 96)).astype(np.float32)
    for scale in (30, 7):
        assert_normalized(lerf_eval.box_blur(t(x), scale), jlerf.box_blur(x, scale), 1e-5)
    mask = rng.uniform(size=(64, 96)) > 0.5
    for scale in (3, 1):
        np.testing.assert_array_equal(n(lerf_eval.mode_smooth(t(mask), scale)),
                                      jlerf.mode_smooth(mask.astype(np.uint8), scale) > 0)


@pytest.mark.parametrize("config,frames", [(SMOKE, (0, 7, 11)),
                                           ("configs/synthetic/replica_scale.yaml", (0, 60))])
def test_gt_semantics_matches_jax(config, frames):
    cfg = load_config(config)
    ds, jds = datasets.SyntheticDataset(cfg), jdatasets.SyntheticDataset(jload_config(config))
    assert tuple(ds.SEMANTIC_LABELS) == tuple(jds.SEMANTIC_LABELS)
    assert len(ds.SEMANTIC_LABELS) == (9 if "replica" in config else 2)
    for idx in frames:
        np.testing.assert_array_equal(ds.gt_semantics(idx), jds.gt_semantics(idx))
    np.testing.assert_array_equal(ds[frames[-1]][0], jds[frames[-1]][0])


class _TwoStage:
    """The same two-stage decode (online 15 -> 32, then 32 -> 768) in both
    frameworks: fixed random linear maps with L2-normalized outputs."""

    def __init__(self, rng):
        self.w15 = rng.normal(size=(15, 32)).astype(np.float32)
        self.w32 = rng.normal(size=(32, 768)).astype(np.float32)

    @staticmethod
    def _l2n(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def numpy(self, z):
        return self._l2n(self._l2n(z @ self.w15) @ self.w32)

    def parts(self, lib):
        if lib == "jax":
            def l2n(x):
                return x / jnp.linalg.norm(x, axis=-1, keepdims=True)
            w15, w32 = jnp.asarray(self.w15), jnp.asarray(self.w32)
            to = jnp.asarray
        else:
            def l2n(x):
                return x / torch.linalg.norm(x, dim=-1, keepdim=True)
            w15, w32 = t(self.w15), t(self.w32)

            def to(x):
                return torch.as_tensor(x, dtype=torch.float32)
        online = types.SimpleNamespace(decode=lambda z: l2n(to(z) @ w15))
        ext = types.SimpleNamespace(decode_codes=lambda z: l2n(to(z) @ w32),
                                    device=torch.device("cpu"))
        return ext, online


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Rendered-map stand-ins on the smoke scene: each pixel's code is its
    class code plus smooth noise; annotations through write_annotations."""
    rng = np.random.default_rng(4)
    cfg = load_config(SMOKE)
    ds = datasets.SyntheticDataset(cfg)
    frames = (1, 5, 9)
    root = tmp_path_factory.mktemp("lerf")
    lang_dir = root / "lang"
    lang_dir.mkdir()
    codes = _unit(rng, 2, 15)
    for idx in frames:
        sem = ds.gt_semantics(idx)
        noise = rng.normal(size=(8, 12, 15))
        noise = np.repeat(np.repeat(noise, 8, axis=0), 8, axis=1) * 0.4
        m = (codes[sem] + noise + rng.normal(size=noise.shape) * 0.1).astype(np.float32)
        np.save(lang_dir / f"{idx:05d}.npy", m.transpose(2, 0, 1))
    holder = types.SimpleNamespace(dataset=ds, labels=list(ds.SEMANTIC_LABELS))
    ann_path = synthetic_miou.write_annotations(holder, frames, root / "ann")
    dec = _TwoStage(rng)
    table = dict(zip(holder.labels, dec.numpy(codes)))
    table.update(zip(relevancy.NEGATIVES, _unit(rng, 4, 768)))
    return dict(ds=ds, lang_dir=lang_dir, ann_path=ann_path, dec=dec, table=table,
                frames=frames)


def test_annotations_match_jax(scene):
    holder = types.SimpleNamespace(dataset=jdatasets.SyntheticDataset(jload_config(SMOKE)),
                                   labels=["wall", "floor"])
    jpath = jsyn.write_annotations(holder, scene["frames"], scene["ann_path"].parent / "jax")
    got, ref = lerf_eval.load_annotations(scene["ann_path"]), jlerf.load_annotations(jpath)
    assert list(got) == list(ref)
    for frame in got:
        assert list(got[frame]) == list(ref[frame])
        for label, q in got[frame].items():
            np.testing.assert_array_equal(q["mask"], ref[frame][label]["mask"])
            np.testing.assert_array_equal(q["bboxes"], ref[frame][label]["bboxes"])


def _polygons(rng, kind, h, w):
    """Random polygons of one kind: convex (sorted angles), concave
    (random order, self-intersecting), with a self-touching vertex, with
    vertices outside the image, or two polygons at once."""
    n = int(rng.integers(3, 12))
    if kind == "convex":
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(3, 0.45 * min(h, w), n)
        pts = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1).round()
        return [pts.astype(np.int32)]
    if kind == "outside":
        return [rng.integers(-20, [w + 20, h + 20], (n, 2)).astype(np.int32)]
    pts = rng.integers(0, [w, h], (n, 2))
    if kind == "touching":
        pts[n // 2] = pts[0]
    if kind == "two":
        return [pts.astype(np.int32), rng.integers(-5, [w + 5, h + 5], (5, 2)).astype(np.int32)]
    return [pts.astype(np.int32)]


@pytest.mark.parametrize("kind", ["convex", "concave", "touching", "outside", "two"])
def test_fill_poly_matches_opencv(kind):
    """eval/polygon.fill_poly against cv2.fillPoly (8-connected, shift 0),
    pixel-exact on 300 random polygons of each kind."""
    import cv2

    from online_lang_splatting_tpu_torch.eval.polygon import fill_poly

    rng = np.random.default_rng(["convex", "concave", "touching", "outside", "two"].index(kind))
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(8, 60, 2))
        polys = _polygons(rng, kind, h, w)
        ref = np.zeros((h, w), np.uint8)
        cv2.fillPoly(ref, polys, 1)
        np.testing.assert_array_equal(fill_poly(np.zeros((h, w), np.uint8), polys, 1), ref)


def test_labelme_annotations_match_jax(scene, tmp_path):
    """A folder of labelme JSONs (the synthetic classes' outer contours as
    polygons, plus polygons reaching outside the image) reads into the
    same masks and boxes as the JAX package's cv2.fillPoly reader."""
    import json

    import cv2

    rng = np.random.default_rng(3)
    ds = scene["ds"]
    for idx in scene["frames"]:
        sem = ds.gt_semantics(idx)
        objects = []
        for cls in np.unique(sem):
            contours, _ = cv2.findContours((sem == cls).astype(np.uint8), cv2.RETR_EXTERNAL,
                                           cv2.CHAIN_APPROX_SIMPLE)
            for c in contours:
                x, y, bw, bh = cv2.boundingRect(c)
                objects.append({"category": ds.SEMANTIC_LABELS[cls],
                                "segmentation": [c[:, 0].tolist()],
                                "bbox": [x, y, x + bw, y + bh]})
        outside = rng.integers(-15, [ds.width + 15, ds.height + 15], (6, 2))
        objects.append({"category": "stray", "segmentation": [outside.tolist()],
                        "bbox": [0, 0, 1, 1]})
        (tmp_path / f"frame_{idx:05d}.json").write_text(json.dumps({
            "info": {"name": f"frame_{idx}.jpg", "width": ds.width, "height": ds.height},
            "objects": objects}))
    got, ref = lerf_eval.load_annotations(tmp_path), jlerf.load_annotations(tmp_path)
    assert list(got) == list(ref) and len(got) == len(scene["frames"])
    for frame in got:
        assert list(got[frame]) == list(ref[frame])
        for label, q in got[frame].items():
            assert q["mask"].any()
            np.testing.assert_array_equal(q["mask"], ref[frame][label]["mask"])
            np.testing.assert_array_equal(q["bboxes"], ref[frame][label]["bboxes"])


_JAX_DECODE_LANG_MAP = jlerf.decode_lang_map


def _jax_decode_lang_map_by_chunks(lang_map, extractor, online_ae=None, out_hw=None):
    """The JAX package's decode_lang_map with its CLIP-space resize done in
    chunks of 128 channels: its single cv2.resize of an (H, W, 768) map
    raises, as OpenCV's resize takes at most 128 channels. Resizing
    channels separately is the same bilinear map."""
    import cv2

    out = _JAX_DECODE_LANG_MAP(lang_map, extractor, online_ae)
    if out_hw is None or tuple(out_hw) == out.shape[:2]:
        return out
    return np.concatenate([cv2.resize(np.ascontiguousarray(out[..., i: i + 128]), (out_hw[1], out_hw[0]),
                                      interpolation=cv2.INTER_LINEAR)
                           for i in range(0, out.shape[-1], 128)], axis=-1)


@pytest.mark.parametrize("eval_size", [(64, 96), (32, 48)])
def test_evaluate_scene_matches_jax(scene, eval_size, monkeypatch):
    """The fused decode -> relevancy path at the map size; at half size the
    decoded CLIP map is resized before scoring and the GT masks with it."""
    monkeypatch.setattr(jlerf, "decode_lang_map", _jax_decode_lang_map_by_chunks)
    ext, online = scene["dec"].parts("torch")
    jext, jonline = scene["dec"].parts("jax")
    args = (str(scene["lang_dir"]), str(scene["ann_path"]))
    got = lerf_eval.evaluate_scene(*args, ext, relevancy.CLIPRelevancy(embed_table=scene["table"], device="cpu"),
                                   online_ae=online, eval_size=eval_size)
    ref = jlerf.evaluate_scene(*args, jext, jrel.CLIPRelevancy(embed_table=scene["table"]),
                               online_ae=jonline, eval_size=eval_size)
    assert got["frames_scored"] == ref["frames_scored"] == 3
    assert got["num_queries"] == ref["num_queries"]
    assert got["distinct_queries"] == ref["distinct_queries"] == 2
    assert got["localization_acc"] == ref["localization_acc"]
    np.testing.assert_allclose(got["miou"], ref["miou"], rtol=0, atol=1e-6)
    assert got["miou"] > 0.5


def test_evaluate_scene_multilevel_matches_jax(scene):
    ext, online = scene["dec"].parts("torch")
    jext, jonline = scene["dec"].parts("jax")
    dirs = [str(scene["lang_dir"])] * 2
    got = lerf_eval.evaluate_scene_multilevel(
        dirs, str(scene["ann_path"]), lambda z: ext.decode_codes(online.decode(z)),
        relevancy.CLIPRelevancy(embed_table=scene["table"], device="cpu"), eval_size=(64, 96), hwc=False)
    ref = jlerf.evaluate_scene_multilevel(
        dirs, str(scene["ann_path"]), lambda z: jext.decode_codes(jonline.decode(z)),
        jrel.CLIPRelevancy(embed_table=scene["table"]), eval_size=(64, 96), hwc=False)
    for key in ("num_queries", "frames_scored", "localization_acc"):
        assert got[key] == ref[key], key
    np.testing.assert_allclose(got["miou"], ref["miou"], rtol=0, atol=1e-6)


def test_activate_stream_matches_jax(scene):
    """Per-query IoUs and chosen levels on a two-level CLIP map (two
    frames' decoded maps as the levels)."""
    frames = scene["frames"]
    ann = lerf_eval.load_annotations(scene["ann_path"])[f"{frames[1]:05d}"]
    ext, online = scene["dec"].parts("torch")
    jext, jonline = scene["dec"].parts("jax")
    levels = []
    for idx in frames[1:]:
        code_map = np.load(scene["lang_dir"] / f"{idx:05d}.npy")
        clip = n(lerf_eval.decode_lang_map(code_map, ext, online))
        assert_normalized(clip, _JAX_DECODE_LANG_MAP(code_map, jext, jonline), 1e-5, "decode")
        levels.append(clip)
    sem = np.stack(levels)
    rel = relevancy.CLIPRelevancy(embed_table=scene["table"], device="cpu")
    jr = jrel.CLIPRelevancy(embed_table=scene["table"])
    rel.set_positives(list(ann))
    jr.set_positives(list(ann))
    ious, lvls = lerf_eval.activate_stream(t(sem), rel, ann)
    jious, jlvls = jlerf.activate_stream(sem, jr, ann)
    np.testing.assert_allclose(ious, jious, rtol=0, atol=1e-6)
    assert lvls == jlvls


def test_lerf_localization_matches_jax():
    """Hits on relevancy maps with one smooth peak per (level, prompt), so
    the blurred argmax is unique (a plateau's argmax would hinge on the
    last bits of OpenCV's FFT filter). Some peaks fall inside the boxes,
    some outside; boxes are given at twice the map's resolution."""
    rng = np.random.default_rng(6)
    h, w, n_lvl, n_prompt = 48, 64, 2, 6
    ys, xs = np.mgrid[0:h, 0:w]
    valid = rng.uniform(0.0, 0.2, (n_lvl, n_prompt, h, w)).astype(np.float32)
    ann = {}
    for k in range(n_prompt):
        for i in range(n_lvl):
            cy, cx = rng.uniform(5, h - 5), rng.uniform(5, w - 5)
            amp = rng.uniform(0.3, 0.8)
            valid[i, k] += amp * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 50.0)
        x1, y1 = rng.integers(0, w), rng.integers(0, h)
        ann[f"q{k}"] = {"mask": np.zeros((2 * h, 2 * w), bool),
                        "bboxes": np.array([[2 * x1, 2 * y1, 2 * x1 + 40, 2 * y1 + 30]])}
    hits = lerf_eval.lerf_localization(None, None, ann, valid_map=t(valid))
    assert hits == jlerf.lerf_localization(None, None, ann, valid_map=valid)
    assert 0 < hits < n_prompt


def _fake_slams(ds, cfg):
    """The same map and trajectory as a minimal `slam` of each package."""
    tree = map_from_frame(ds, frame=3, n_pts=500)
    w, h = ds.width, ds.height
    proj = graphics.projection_matrix(0.01, 100.0, ds.cx, ds.cy, ds.fx, ds.fy, w, h)
    rng = np.random.default_rng(5)
    cams = {}
    for idx in range(len(ds)):
        pose = ds.poses[idx].astype(np.float32)
        cams[idx] = types.SimpleNamespace(
            image=None, r=pose[:3, :3], t=pose[:3, 3] + rng.normal(size=3).astype(np.float32) * 0.01,
            r_gt=pose[:3, :3], t_gt=pose[:3, 3])
    kw = dict(image_height=h, image_width=w, tanfovx=np.tan(ds.fovx / 2),
              tanfovy=np.tan(ds.fovy / 2), sh_degree=0)
    fe = types.SimpleNamespace(kf_indices=[0, 3, 6], cameras=cams)
    tp, ta, _ = gaussians_from_numpy(tree)
    jp, ja = jax_params_aux(tree)
    port = types.SimpleNamespace(
        frontend=fe, backend=types.SimpleNamespace(params=tp, aux=ta), dataset=ds, proj=proj,
        settings=RasterSettings(backend="cuda", tile=16, **kw), config=cfg,
        device=torch.device("cpu"))
    ref = types.SimpleNamespace(
        frontend=fe, backend=types.SimpleNamespace(params=jp, aux=ja),
        dataset=jdatasets.SyntheticDataset(cfg), proj=jnp.asarray(n(proj)),
        settings=JSettings(backend="oracle", tile=16, **kw), config=cfg)
    return port, ref


def test_evaluate_run_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("OLS_LPIPS_WEIGHTS", raising=False)
    cfg = load_config(SMOKE)
    port, ref = _fake_slams(datasets.SyntheticDataset(cfg), cfg)
    got = evaluation.evaluate_run(port, tmp_path / "port", every=4)
    want = jevaluation.evaluate_run(ref, tmp_path / "jax", every=4)
    assert got["lpips_metric"] == want["lpips_metric"] == "msssim_proxy"
    for key in ("mean_psnr", "mean_ssim", "mean_lpips", "ate_rmse"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    saved = sorted(p.name for p in (tmp_path / "port" / "before_opt" / "lang").glob("*.npy"))
    assert saved == ["00004.npy", "00008.npy"]
    for name in saved:
        assert_normalized(np.load(tmp_path / "port" / "before_opt" / "lang" / name),
                          np.load(tmp_path / "jax" / "before_opt" / "lang" / name), 1e-4, name)

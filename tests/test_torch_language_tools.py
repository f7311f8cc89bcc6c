"""The port's language tools against the JAX package's scripts on the CPU:
eval/colors and eval/colormaps (PNG pixels against cv2.imwrite's), the
demo (float32 and --bf16), label saving, the offline autoencoder trainer
(its label resize against OpenCV per 128-channel chunk, its steps and
saved tree against the JAX script from the same initial weights), the
autoencoder round trip (one- and two-stage), and PCA training and
testing.

The JAX scripts run through their own `main` (loaded by path, sys.argv
set), the port's tools through theirs (`--device cpu`). Both extractors
get the same small ConvNeXt tower (monkeypatched) with perturbed seeded
weights read from the same npz files, at a 64^2 CLIP resolution (128^2
for bf16); both text towers are one narrow block with CLIP's vocabulary.
Tolerances: float32 feature maps 1e-4 normalized (the towers' tolerance,
tests/test_torch_language_models.py); bf16 maps per-pixel cosine >= 0.99
and 0.1 normalized (measured 0.996 and 0.069: both run the towers in
bfloat16, whose rounding differs op by op); PCA and heatmap PNGs of
float32 maps within one 8-bit step on >= 99 % of pixels, of the bf16
maps a mean difference <= 4 steps (measured 0.87 and 2.32); the trainer's
losses 1e-5 relative and its saved tree 1e-4 normalized; round-trip
metrics 1e-5 relative, PCA metrics equal at the JAX script's printed
precision; colormaps, colours, the label resize (<= 1e-6)
and PNG pixels exact where inputs are equal.
"""

import functools
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_helpers import assert_normalized, n

from online_lang_splatting_tpu.models import autoencoder as jae
from online_lang_splatting_tpu.models import convnext_clip as jconv
from online_lang_splatting_tpu.models import sed as jsed
from online_lang_splatting_tpu.models import text_tower as jtext
from online_lang_splatting_tpu_torch import convert
from online_lang_splatting_tpu_torch.eval import colormaps, colors
from online_lang_splatting_tpu_torch.models import autoencoder as ae
from online_lang_splatting_tpu_torch.models import sed
from online_lang_splatting_tpu_torch.models.checkpoints import save_npz_tree
from online_lang_splatting_tpu_torch.models.convnext_clip import ConvNeXtCLIPVisual
from online_lang_splatting_tpu_torch.models.hr_net import HighResLanguageFeatureNet
from online_lang_splatting_tpu_torch.models.init import make_generator
from online_lang_splatting_tpu_torch.models.text_tower import TextTower
from online_lang_splatting_tpu_torch.tools import (language_features, save_labels,
                                                   test_autoencoder, test_pca,
                                                   train_encoder_light, train_pca)
from online_lang_splatting_tpu_torch.utils.png import read_rgb8, write_png

REPO = Path(__file__).resolve().parents[1]
DEPTHS, DIMS = (1, 1, 1, 1), (8, 16, 24, 32)
TEXT = dict(width=32, heads=2, layers=1)
RES = (64, 64)


@functools.cache
def _script(rel: str):
    spec = importlib.util.spec_from_file_location("jax_tool_" + Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _jax_main(monkeypatch, rel: str, argv):
    monkeypatch.setattr(sys, "argv", [rel, *map(str, argv)])
    return _script(rel).main()


@pytest.fixture
def light(monkeypatch):
    """The same small tower and narrow text tower in both packages, at a
    small CLIP resolution; the JAX scripts' imports on sys.path."""
    monkeypatch.setattr(jsed, "ConvNeXtCLIPVisual", functools.partial(
        jconv.ConvNeXtCLIPVisual, depths=DEPTHS, dims=DIMS, embed_dim=768, stem_mode="conv",
        gelu_mode="erf", head_mode="mlp"))
    monkeypatch.setattr(jsed, "CLIP_RESOLUTION", RES)
    monkeypatch.setattr(jtext, "TextTower", functools.partial(jtext.TextTower, **TEXT))
    monkeypatch.setattr(sed, "LangFeatureExtractor", functools.partial(
        sed.LangFeatureExtractor, depths=DEPTHS, dims=DIMS, embed_dim=768))
    monkeypatch.setattr(sed, "CLIP_RESOLUTION", RES)
    monkeypatch.syspath_prepend(str(REPO))
    return monkeypatch


def _perturbed(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded weights moved off their init (layer-scale gamma 1e-6 would
    hide the ConvNeXt blocks); BatchNorm variances kept above 0.5."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, v in model.state_dict().items():
            if not v.is_floating_point():
                continue
            noise = torch.randn(v.shape, generator=g)
            if name.endswith("running_var"):
                v.copy_(0.5 + noise.abs())
            else:
                v.add_(0.05 * noise)
    return model


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Weights directories: one-stage (small tower, HR head, 768 -> 15 AE,
    narrow text tower), two-stage (the 768 -> 32 AE, the same rest) and the
    online 32 <-> 15 codec."""
    root = tmp_path_factory.mktemp("weights")
    visual = _perturbed(ConvNeXtCLIPVisual(DEPTHS, DIMS, 768, generator=make_generator(1)), 1)
    hr = _perturbed(HighResLanguageFeatureNet(768, DIMS[1], DIMS[0], 768,
                                              generator=make_generator(2)), 2)
    text = TextTower(**TEXT, generator=make_generator(3))
    for name, enc, dec in (("w1", ae.ONE_STAGE_ENC, ae.ONE_STAGE_DEC),
                           ("w2", ae.TWO_STAGE_ENC, ae.TWO_STAGE_DEC)):
        (root / name).mkdir()
        model = _perturbed(ae.AutoencoderMLP(enc, dec, generator=make_generator(len(enc))), 4)
        for fname, tree in (("clip_visual", convert.visual_to_numpy(visual.state_dict())),
                            ("hr_net", convert.hr_to_numpy(hr.state_dict())),
                            ("autoencoder", convert.ae_to_numpy(model.state_dict())),
                            ("clip_text", convert.text_to_numpy(text.state_dict(),
                                                                TEXT["heads"]))):
            save_npz_tree(root / name / f"{fname}.npz", tree)
    online = ae.EncoderDecoderOnline(generator=make_generator(5))
    save_npz_tree(root / "online_ae.npz",
                  {"params": convert.online_ae_to_numpy(online.state_dict())})
    return root


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Two PNGs and a JPEG (40 x 56), smooth colour fields with noise."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    from PIL import Image

    for i, ext in enumerate(("png", "jpg", "png")):
        yy, xx = np.mgrid[:40, :56]
        img = np.stack([yy * 5 + 20 * i, xx * 4, (yy + xx) * 2], -1) + rng.integers(0, 30, (40, 56, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / f"img_{i}.{ext}", quality=90)
    return root


@pytest.fixture(scope="module")
def labels(tmp_path_factory):
    """Seeded (768, 48, 48) feature labels: smooth fields, unit-ish norm."""
    root = tmp_path_factory.mktemp("labels")
    rng = np.random.default_rng(1)
    for i in range(3):
        coarse = rng.normal(size=(768, 6, 6)).astype(np.float32)
        fine = np.repeat(np.repeat(coarse, 8, 1), 8, 2) + rng.normal(size=(768, 48, 48)) * 0.3
        np.save(root / f"frame{i}_f.npy", (fine / np.sqrt(768)).astype(np.float32))
    return root


def _pngs_close(a, b, mean_steps=None):
    """8-bit PNG pixels within one step on >= 99 % of pixels, or (for the
    bf16 maps) a mean difference of at most `mean_steps` steps."""
    x, y = read_rgb8(a).astype(int), read_rgb8(b).astype(int)
    assert x.shape == y.shape
    d = np.abs(x - y)
    if mean_steps is not None:
        assert d.mean() <= mean_steps, d.mean()
    else:
        assert np.mean(d <= 1) >= 0.99, d.max()


# -- eval/colors.py and eval/colormaps.py ----------------------------------

def test_colors_match_jax(light):
    jcolors = _script("eval/colors.py")
    assert list(colors.COLORS_DICT) == list(jcolors.COLORS_DICT)
    for k, v in jcolors.COLORS_DICT.items():
        np.testing.assert_array_equal(colors.get_color(k), jcolors.get_color(k))
        np.testing.assert_array_equal(colors.COLORS_DICT[k], v)
    np.testing.assert_array_equal(colors.get_color([0.1, 0.2, 0.3]),
                                  jcolors.get_color([0.1, 0.2, 0.3]))
    with pytest.raises(ValueError):
        colors.get_color("nope")


@pytest.mark.parametrize("opts", [dict(), dict(normalize=True), dict(colormap="gray"),
                                  dict(colormap_min=0.2, colormap_max=0.7, invert=True)])
def test_colormaps_bitwise_and_png_pixels_match_cv2(light, tmp_path, opts):
    """apply_colormap / apply_pca_colormap / apply_boolean_colormap equal
    the JAX module bitwise; colormap_saving and vis_mask_save write the
    pixels cv2.imwrite writes for the same arrays."""
    import cv2

    jcm = _script("eval/colormaps.py")
    rng = np.random.default_rng(2)
    scalar = rng.uniform(-0.2, 1.3, (17, 23)).astype(np.float32)
    got = colormaps.apply_colormap(scalar, colormaps.ColormapOptions(**opts))
    ref = jcm.apply_colormap(scalar, jcm.ColormapOptions(**opts))
    np.testing.assert_array_equal(got, ref)
    feat = rng.normal(size=(21, 19, 12)).astype(np.float32)
    np.testing.assert_array_equal(colormaps.apply_pca_colormap(feat), jcm.apply_pca_colormap(feat))
    mask = rng.uniform(size=(9, 7)) > 0.5
    np.testing.assert_array_equal(colormaps.apply_boolean_colormap(mask),
                                  jcm.apply_boolean_colormap(mask))
    colormaps.colormap_saving(scalar, colormaps.ColormapOptions(**opts), tmp_path / "p.png")
    jcm.colormap_saving(scalar, jcm.ColormapOptions(**opts), tmp_path / "j.png")
    np.testing.assert_array_equal(read_rgb8(tmp_path / "p.png"), read_rgb8(tmp_path / "j.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED))
    colormaps.vis_mask_save(mask, tmp_path / "pm.png")
    jcm.vis_mask_save(mask, tmp_path / "jm.png")
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "pm.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "jm.png"), cv2.IMREAD_UNCHANGED))


# -- the demo and label saving ----------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_language_features_demo_matches_jax(light, weights, images, tmp_path, bf16):
    """The demo's saved (768, H/4, W/4) map, PCA picture and query heatmap
    against the JAX script's, in float32 on a JPEG and with --bf16 on a PNG
    at the CLIP resolution (no resize, so both packages run the towers in
    bfloat16)."""
    img = images / "img_1.jpg"
    if bf16:
        res = (128, 128)
        light.setattr(jsed, "CLIP_RESOLUTION", res)
        light.setattr(sed, "CLIP_RESOLUTION", res)
        rgb = np.random.default_rng(5).integers(0, 256, (*res, 3), dtype=np.uint8)
        write_png(tmp_path / "sq.png", rgb)
        img = tmp_path / "sq.png"
    argv = ["--lang-model", weights / "w1", "--high-res-model", weights / "w1",
            "--input", img, "--query-text", "chair"] + (["--bf16"] if bf16 else [])
    _jax_main(light, "language/language_features.py",
              [*argv, "--output-dir", tmp_path / "j", "--device", "cpu"])
    got = language_features.main([*map(str, argv), "--output-dir", str(tmp_path / "p"),
                                  "--device", "cpu"])
    stem = img.stem
    p, j = np.load(tmp_path / "p" / f"{stem}_f.npy"), np.load(tmp_path / "j" / f"{stem}_f.npy")
    assert p.shape == j.shape == (768, 32, 32) if bf16 else (768, 16, 16)
    assert got["shape"] == list(p.shape[1:]) + [768] and got["steady_ms"] > 0
    if bf16:
        cos = (p * j).sum(0) / np.linalg.norm(p, axis=0) / np.linalg.norm(j, axis=0)
        assert cos.min() >= 0.99, cos.min()
        assert_normalized(p, j, 0.1, "bf16 map")
    else:
        assert_normalized(p, j, 1e-4, "map")
    for name in (f"{stem}_pca.png", f"{stem}_heatmap_chair.png"):
        _pngs_close(tmp_path / "p" / name, tmp_path / "j" / name, 4.0 if bf16 else None)


def test_save_labels_matches_jax(light, weights, images, tmp_path):
    argv = ["--input-dir", images, "--weights-dir", weights / "w1", "--every", "1",
            "--visualize"]
    _jax_main(light, "language/save_labels.py", [*argv, "--output-dir", tmp_path / "j",
                                                 "--cpu"])
    got = save_labels.main([*map(str, argv), "--output-dir", str(tmp_path / "p"),
                            "--device", "cpu"])
    assert len(got["files"]) == 3 and len(got["ms"]) == 3
    for f in got["files"]:
        name = Path(f).name
        assert_normalized(np.load(f), np.load(tmp_path / "j" / name), 1e-4, name)
        stem = name[: -len("_f.npy")]
        _pngs_close(tmp_path / "p" / f"{stem}_pca.png", tmp_path / "j" / f"{stem}_pca.png")


# -- the offline autoencoder trainer ---------------------------------------

def _cv2_resize_by_chunks(feat_chw, target):
    """OpenCV's INTER_LINEAR resize of an (H, W, 768) map, 128 channels at a
    time (one call on 768 channels raises)."""
    import cv2

    hwc = np.ascontiguousarray(feat_chw.transpose(1, 2, 0))
    return np.concatenate([cv2.resize(np.ascontiguousarray(hwc[..., i: i + 128]), (target, target),
                                      interpolation=cv2.INTER_LINEAR)
                           for i in range(0, hwc.shape[-1], 128)], axis=-1)


def _jax_load_labels_by_chunks(data_dir, target=24):
    import glob

    out = [_cv2_resize_by_chunks(np.load(f), target).reshape(-1, 768)
           for f in sorted(glob.glob(f"{data_dir}/*.npy"))]
    return np.concatenate(out, axis=0).astype(np.float32)


def test_load_labels_matches_opencv_by_chunks(tmp_path):
    """The trainer's half-pixel F.interpolate resize against cv2.resize per
    128-channel chunk (<= 1e-6), on a full (768, 192, 192) label; the JAX
    script's single cv2.resize of it raises."""
    import cv2

    feat = np.random.default_rng(3).normal(size=(768, 192, 192)).astype(np.float32)
    np.save(tmp_path / "a_f.npy", feat)
    got = train_encoder_light.load_labels(str(tmp_path))
    assert got.shape == (576, 768)
    np.testing.assert_allclose(got, _cv2_resize_by_chunks(feat, 24).reshape(-1, 768), atol=1e-6)
    with pytest.raises(cv2.error):
        cv2.resize(feat.transpose(1, 2, 0), (24, 24), interpolation=cv2.INTER_LINEAR)


def test_train_encoder_light_matches_jax(light, labels, tmp_path, capsys):
    """Three epochs of two AdamW steps each (1728 vectors, batch 768) from
    the JAX script's initial weights: the per-epoch losses the JAX script
    prints and its saved npz tree."""
    import jax
    import jax.numpy as jnp

    jvars = jae.AutoencoderMLP().init(jax.random.key(0), jnp.zeros((2, 768)), train=True)
    state = convert.language_from_numpy(ae=jax.tree.map(np.asarray, dict(jvars)))["ae"]

    def init_from_jax(enc, dec, device):
        model = ae.AutoencoderMLP(enc, dec)
        model.load_state_dict(state)
        return model.to(device)

    light.setattr(train_encoder_light, "init_model", init_from_jax)
    light.setattr(_script("language/autoencoder/train_encoder_light.py"), "load_labels",
                  _jax_load_labels_by_chunks)
    argv = ["--data-dir", labels, "--epochs", "3", "--batch-size", "768"]
    _jax_main(light, "language/autoencoder/train_encoder_light.py",
              [*argv, "--out", tmp_path / "j.npz", "--cpu"])
    printed = [float(x) for x in re.findall(r"epoch \d+: loss ([0-9.]+)", capsys.readouterr().out)]
    got = train_encoder_light.main([*map(str, argv), "--out", str(tmp_path / "p.npz"),
                                    "--device", "cpu"])
    assert got["vectors"] == 3 * 576 and len(got["loss"]) == 3
    assert got["loss"][-1] < got["loss"][0]
    np.testing.assert_allclose([got["loss"][0], got["loss"][2]], printed, rtol=1e-5, atol=1e-6)
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(p.files) == sorted(j.files)
    for k in j.files:
        assert_normalized(p[k], j[k], 1e-4, k)


# -- round trip and PCA ---------------------------------------------------

@pytest.mark.parametrize("stage", [1, 2])
def test_autoencoder_round_trip_matches_jax(light, weights, labels, tmp_path, stage):
    w = weights / ("w1" if stage == 1 else "w2")
    argv = ["--weights-dir", w, "--features", labels, "--limit", "2"]
    if stage == 2:
        argv += ["--online-ae", weights / "online_ae.npz"]
    ref = _jax_main(light, "language/test_autoencoder.py",
                    [*argv, "--viz", tmp_path / "j", "--cpu"])
    got = test_autoencoder.main([*map(str, argv), "--viz", str(tmp_path / "p"),
                                 "--device", "cpu"])
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)
    for name in ("frame0_f_roundtrip.png", "frame1_f_roundtrip.png"):
        _pngs_close(tmp_path / "p" / name, tmp_path / "j" / name)


def test_pca_tools_match_jax(light, weights, labels, tmp_path, capsys):
    """train_pca's npz equals the JAX script's exactly (the same float64
    IncrementalPCA); test_pca's mean mse and cos equal what the JAX script
    prints (5 and 4 decimals), its heatmaps within one 8-bit step."""
    argv = ["--feat-dirs", labels, "--every", "1", "--components", "7"]
    _jax_main(light, "language/autoencoder/pca/train_pca.py",
              [*argv, "--out", tmp_path / "j.npz", "--cpu"])
    assert train_pca.main([*map(str, argv), "--out", str(tmp_path / "p.npz"),
                           "--device", "cpu"])["files"] == 3
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(p.files) == sorted(j.files)
    for k in j.files:
        np.testing.assert_array_equal(p[k], j[k])
    capsys.readouterr()
    argv = ["--model", tmp_path / "p.npz", "--features", labels, "--every", "1",
            "--query", "chair", "--weights-dir", weights / "w1"]
    _jax_main(light, "language/autoencoder/pca/test_pca.py",
              [*argv, "--out", tmp_path / "j", "--cpu"])
    printed = re.search(r"mean mse [0-9.]+  mean cos [0-9.]+", capsys.readouterr().out)[0]
    got = test_pca.main([*map(str, argv), "--out", str(tmp_path / "p"), "--device", "cpu"])
    assert got["files"] == 3
    assert f"mean mse {got['mean_mse']:.5f}  mean cos {got['mean_cos']:.4f}" == printed
    for i in range(3):
        _pngs_close(tmp_path / "p" / f"frame{i}_f_heatmap.png",
                    tmp_path / "j" / f"frame{i}_f_heatmap.png")


# -- the bf16 extractor -------------------------------------------------------

def test_bf16_extractor_matches_jax_at_128(weights):
    """LangFeatureExtractor(compute_dtype=bfloat16) against the JAX bf16
    extractor at 128^2 (the frame at the CLIP resolution): hr_features and
    encode_frame float32 outputs, per-pixel cosine >= 0.99, 0.1
    normalized; the autoencoder stays float32 and the tower's weights are
    cast once. Also float32 input into the bf16 tower and bf16 input into
    a float32 tower compute in float32 (flax's promotion)."""
    import jax.numpy as jnp

    from online_lang_splatting_tpu_torch.models.checkpoints import load_npz_tree

    trees = {k: load_npz_tree(weights / "w1" / f"{f}.npz")
             for k, f in (("visual", "clip_visual"), ("hr", "hr_net"), ("ae", "autoencoder"))}
    jvis = functools.partial(jconv.ConvNeXtCLIPVisual, depths=DEPTHS, dims=DIMS, embed_dim=768,
                             stem_mode="conv", gelu_mode="erf", head_mode="mlp")
    rgb = np.random.default_rng(6).uniform(0, 255, (128, 128, 3)).astype(np.float32)
    orig = jsed.ConvNeXtCLIPVisual
    jsed.ConvNeXtCLIPVisual = jvis
    try:
        jx = jsed.LangFeatureExtractor(trees["visual"], trees["hr"], trees["ae"],
                                       compute_dtype=jnp.bfloat16, clip_resolution=(128, 128))
        ref_hr, ref_code = np.asarray(jx.hr_features(rgb)), np.asarray(jx.encode_frame(rgb))
    finally:
        jsed.ConvNeXtCLIPVisual = orig
    states = convert.language_from_numpy(**trees)
    ex = sed.LangFeatureExtractor(states["visual"], states["hr"], states["ae"],
                                  clip_resolution=(128, 128), depths=DEPTHS, dims=DIMS,
                                  embed_dim=768, compute_dtype=torch.bfloat16, device="cpu")
    assert ex.visual.trunk.stem[0].weight.dtype == torch.bfloat16
    assert ex.hr.final_conv.weight.dtype == torch.bfloat16
    assert ex.ae.encoder[0].weight.dtype == torch.float32
    got_hr, got_code = ex.hr_features(rgb), ex.encode_frame(rgb)
    assert got_hr.dtype == got_code.dtype == torch.float32
    for got, ref in ((n(got_hr), ref_hr), (n(got_code), ref_code)):
        cos = (got * ref).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(ref, axis=-1)
        assert cos.min() >= 0.99, cos.min()
        assert_normalized(got, ref, 0.1)
    # Promotion: a float32 input into the bf16 tower computes in float32.
    x = torch.as_tensor(rgb).permute(2, 0, 1)[None] / 255.0
    with torch.no_grad():
        out = ex.visual(x)["res2"]
        assert out.dtype == torch.float32
        up = ConvNeXtCLIPVisual(DEPTHS, DIMS, 768)
        up.load_state_dict({k: v.float() for k, v in ex.visual.state_dict().items()})
        assert_normalized(out, up(x)["res2"], 1e-6, "promoted")
        assert up(x.to(torch.bfloat16))["res2"].dtype == torch.float32

"""Port parity of the language models: the ConvNeXt CLIP tower, the HR
head, both autoencoders and their optimizers, the fused `encode_frame`,
the text tower, the tokenizer, the weight conversion and checkpoint
loading.

Each JAX module is built in its reference-exact modes (erf GELU, conv
stem, per-location head, XLA ConvTranspose), its flax parameters are
perturbed from a numpy seed so no layer is near its init (layer-scale
gamma 1e-6 would hide the ConvNeXt blocks), and they reach the port
through `convert.language_from_numpy`. Tolerances are normalized max
errors (torch_helpers.assert_normalized): 1e-4 for the towers, the HR head,
the fused path and the text tower, 1e-5 for the autoencoders and the
online steps, 1e-4 for the offline AdamW steps.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import assert_normalized, n, t

from online_lang_splatting_tpu.models import autoencoder as jae
from online_lang_splatting_tpu.models import convnext_clip as jconv
from online_lang_splatting_tpu.models import hr_net as jhr
from online_lang_splatting_tpu.models import text_tower as jtext
from online_lang_splatting_tpu.models import tokenizer as jtok
from online_lang_splatting_tpu_torch import convert
from online_lang_splatting_tpu_torch.models import autoencoder as ae
from online_lang_splatting_tpu_torch.models import convnext_clip as conv
from online_lang_splatting_tpu_torch.models import hr_net, tokenizer
from online_lang_splatting_tpu_torch.models.checkpoints import (
    OnlineAETrainer, load_extractor_from_dir)
from online_lang_splatting_tpu_torch.models.sed import LangFeatureExtractor
from online_lang_splatting_tpu_torch.models.text_tower import TextTower

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import convert_weights as CW  # noqa: E402

DEPTHS, DIMS, EMBED = (1, 2, 2, 1), (8, 16, 24, 32), 16


def _perturb(tree, rng, scale=0.1):
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=np.shape(a)) * scale).astype(np.float32),
        tree)


def _stats(tree, rng):
    """Perturbed BatchNorm statistics: means around 0, variances above 1."""
    return jax.tree.map(
        lambda a: (np.asarray(a) + np.abs(rng.normal(size=np.shape(a))) * 0.3
                   ).astype(np.float32), tree)


def _jax_visual(embed=EMBED):
    return jconv.ConvNeXtCLIPVisual(depths=DEPTHS, dims=DIMS, embed_dim=embed,
                                    stem_mode="conv", gelu_mode="erf", head_mode="mlp")


def _visual_params(rng, embed=EMBED):
    p = _jax_visual(embed).init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))["params"]
    return _perturb(p, rng)


def _hr_vars(rng, fv_c):
    v = jhr.HighResLanguageFeatureNet().init(
        jax.random.key(1), jnp.zeros((1, 2, 2, fv_c)), jnp.zeros((1, 8, 8, DIMS[1])),
        jnp.zeros((1, 16, 16, DIMS[0])))
    return {"params": _perturb(v["params"], rng, 0.05),
            "batch_stats": _stats(v["batch_stats"], rng)}


def _ae_vars(rng, enc, dec, clip_dim=768):
    v = jae.AutoencoderMLP(enc, dec).init(jax.random.key(2), jnp.zeros((1, clip_dim)))
    return {"params": _perturb(v["params"], rng, 0.02),
            "batch_stats": _stats(v["batch_stats"], rng)}


def _unit_rows(rng, rows, dim):
    x = rng.normal(size=(rows, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(autouse=True)
def _reference_convt(monkeypatch):
    monkeypatch.delenv("OLS_HR_CONVT", raising=False)


def test_convnext_tower_matches_jax():
    rng = np.random.default_rng(0)
    params = _visual_params(rng)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    ref = _jax_visual().apply({"params": params}, jnp.asarray(x))
    model = conv.ConvNeXtCLIPVisual(DEPTHS, DIMS, EMBED)
    model.load_state_dict(convert.language_from_numpy(visual=params)["visual"])
    with torch.no_grad():
        got = model(t(x).permute(0, 3, 1, 2))
    assert set(got) == {"stem", "res2", "res3", "res4", "res5", "clip_vis_dense"}
    for key in got:
        assert_normalized(got[key].permute(0, 2, 3, 1), ref[key], 1e-4, key)


@pytest.mark.parametrize("in_hw,out_hw", [((680, 1200), (768, 768)), ((17, 9), (5, 23))])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    """Includes the extractor's 1200x680 -> 768^2 resize, downscale in
    width and upscale in height, where the JAX version clamps the source
    coordinate at the borders."""
    x = np.random.default_rng(1).uniform(0, 255, (1,) + in_hw + (3,)).astype(np.float32)
    ref = jconv.resize_bilinear(jnp.asarray(x), out_hw)
    got = conv.resize_bilinear(t(x).permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)
    assert_normalized(got, ref, 1e-5)
    img = x[0]
    assert_normalized(conv.normalize_image(t(img)), jconv.normalize_image(jnp.asarray(img)), 1e-6)


def test_hr_head_matches_jax():
    rng = np.random.default_rng(2)
    fv_c = 32
    variables = _hr_vars(rng, fv_c)
    fv = rng.normal(size=(1, 3, 3, fv_c)).astype(np.float32)
    res3 = rng.normal(size=(1, 10, 10, DIMS[1])).astype(np.float32)
    res2 = rng.normal(size=(1, 20, 20, DIMS[0])).astype(np.float32)
    ref = jhr.HighResLanguageFeatureNet().apply(
        variables, jnp.asarray(fv), jnp.asarray(res3), jnp.asarray(res2))
    model = hr_net.HighResLanguageFeatureNet(fv_c, DIMS[1], DIMS[0], 768).eval()
    model.load_state_dict(convert.language_from_numpy(hr=variables)["hr"])
    with torch.no_grad():
        got = model(*(t(a).permute(0, 3, 1, 2) for a in (fv, res3, res2)))
    assert got.shape == (1, 768, 24, 24)
    assert_normalized(got.permute(0, 2, 3, 1), ref, 1e-4)


@pytest.mark.parametrize("stage", [1, 2])
def test_autoencoder_encode_decode_matches_jax(stage):
    enc, dec = ((jae.ONE_STAGE_ENC, jae.ONE_STAGE_DEC) if stage == 1
                else (jae.TWO_STAGE_ENC, jae.TWO_STAGE_DEC))
    assert (enc, dec) == ((ae.ONE_STAGE_ENC, ae.ONE_STAGE_DEC) if stage == 1
                          else (ae.TWO_STAGE_ENC, ae.TWO_STAGE_DEC))
    rng = np.random.default_rng(3)
    variables = _ae_vars(rng, enc, dec)
    x = _unit_rows(rng, 64, 768)
    jm = jae.AutoencoderMLP(enc, dec)
    ref_z = jm.apply(variables, jnp.asarray(x), method=jae.AutoencoderMLP.encode)
    ref_y = jm.apply(variables, ref_z, method=jae.AutoencoderMLP.decode)
    model = ae.AutoencoderMLP(enc, dec).eval()
    model.load_state_dict(convert.language_from_numpy(ae=variables)["ae"])
    with torch.no_grad():
        z = model.encode(t(x))
        y = model.decode(t(n(ref_z)))
    assert z.shape == (64, enc[-1])
    assert_normalized(z, ref_z, 1e-5, "encode")
    assert_normalized(y, ref_y, 1e-5, "decode")


def test_online_autoencoder_and_train_steps_match_jax():
    rng = np.random.default_rng(4)
    jm = jae.EncoderDecoderOnline()
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(3), jnp.zeros((1, 32)))["params"])
    x0 = _unit_rows(rng, 48, 32)
    model = ae.EncoderDecoderOnline()
    model.load_state_dict(convert.language_from_numpy(online_ae=params)["online_ae"])
    with torch.no_grad():
        assert_normalized(model.encode(t(x0)), jm.apply({"params": params}, jnp.asarray(x0),
                                                        method=jae.EncoderDecoderOnline.encode),
                          1e-5, "encode")
        assert_normalized(model(t(x0)), jm.apply({"params": params}, jnp.asarray(x0)),
                          1e-5, "round trip")

    jopt = jae.make_online_optimizer()
    jstate = jopt.init(params)
    jstep = jax.jit(jae.online_train_step(jm, jopt))
    opt = ae.make_online_optimizer(model)
    for i in range(5):
        x = _unit_rows(rng, 48, 32)
        params, jstate, jloss = jstep(params, jstate, jnp.asarray(x))
        loss = ae.online_train_step(model, opt, t(x))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = convert.language_from_numpy(online_ae=jax.tree.map(np.asarray, params))["online_ae"]
    for k, v in model.state_dict().items():
        assert_normalized(v, want[k], 1e-5, k)


def test_offline_train_steps_match_jax():
    """5 AdamW steps with the warmup/cosine schedule and BatchNorm batch
    statistics (params and the running statistics they fold in)."""
    rng = np.random.default_rng(5)
    enc, dec = jae.TWO_STAGE_ENC, jae.TWO_STAGE_DEC
    jm = jae.AutoencoderMLP(enc, dec)
    variables = jax.tree.map(np.asarray, dict(jm.init(jax.random.key(4), jnp.zeros((1, 768)))))
    model = ae.AutoencoderMLP(enc, dec)
    model.load_state_dict(convert.language_from_numpy(ae=variables)["ae"])
    jopt = jae.make_offline_optimizer()
    jstate = jopt.init(variables["params"])
    jstep = jax.jit(jae.offline_train_step(jm, jopt))
    opt = ae.make_offline_optimizer(model)
    for _ in range(5):
        x = _unit_rows(rng, 64, 768)
        variables, jstate, jloss = jstep(variables, jstate, jnp.asarray(x))
        loss = ae.offline_train_step(model, opt, t(x))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = convert.language_from_numpy(ae=jax.tree.map(np.asarray, variables))["ae"]
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 5
        else:
            assert_normalized(v, want[k], 1e-4, k)


def test_offline_schedule_matches_optax():
    sched, jsched = ae.offline_schedule(), jae.offline_schedule()
    for count in (0, 1, 25, 49, 50, 51, 700, 3000, 6049, 6050, 9000):
        np.testing.assert_allclose(sched(count), float(jsched(count)), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("use_hr", [True, False])
def test_encode_frame_matches_jax_chain(use_hr):
    """The fused frame -> codes path on a small tower against the chain
    the JAX package's sed.py:_encode_frame composes."""
    rng = np.random.default_rng(6)
    embed = 768
    visual = _visual_params(rng, embed)
    hr_vars = _hr_vars(rng, embed) if use_hr else None
    enc, dec = jae.TWO_STAGE_ENC, jae.TWO_STAGE_DEC
    ae_vars = _ae_vars(rng, enc, dec)
    rgb = rng.uniform(0, 255, (40, 56, 3)).astype(np.float32)
    res = (64, 64)

    x = jconv.resize_bilinear(jconv.normalize_image(jnp.asarray(rgb))[None], res)
    feats = _jax_visual(embed).apply({"params": visual}, x)
    dense = feats["clip_vis_dense"]
    hr = (jhr.HighResLanguageFeatureNet().apply(hr_vars, dense, feats["res3"], feats["res2"])
          if use_hr else dense)
    code = jae.AutoencoderMLP(enc, dec).apply(ae_vars, hr.reshape(-1, 768),
                                              method=jae.AutoencoderMLP.encode)
    ref = code.reshape(hr.shape[1], hr.shape[2], -1)

    states = convert.language_from_numpy(visual=visual, hr=hr_vars, ae=ae_vars)
    ex = LangFeatureExtractor(states["visual"], states.get("hr"), states["ae"],
                              encoder_dims=enc, decoder_dims=dec, use_hr=use_hr,
                              clip_resolution=res, depths=DEPTHS, dims=DIMS,
                              embed_dim=embed, device="cpu")
    got = ex.encode_frame(rgb)
    assert got.shape == ((16, 16, 32) if use_hr else (2, 2, 32))
    assert_normalized(got, ref, 1e-4, "encode_frame")
    assert_normalized(ex.hr_features(rgb), hr[0], 1e-4, "hr_features")
    assert_normalized(ex.dense_clip(rgb)["res3"], feats["res3"], 1e-4, "dense_clip")
    assert_normalized(ex.decode_codes(got), jae.AutoencoderMLP(enc, dec).apply(
        ae_vars, jnp.asarray(n(got)), method=jae.AutoencoderMLP.decode), 1e-5, "decode")


def test_text_tower_matches_jax():
    rng = np.random.default_rng(7)
    kw = dict(vocab_size=49408, context_length=77, width=64, heads=4, layers=2, embed_dim=32)
    jm = jtext.TextTower(**kw)
    tokens = tokenizer.SimpleTokenizer()(["a photo of a cat", "wooden floor", "texture"])
    params = _perturb(jm.init(jax.random.key(5), jnp.asarray(tokens))["params"], rng, 0.05)
    ref = jm.apply({"params": params}, jnp.asarray(tokens))
    model = TextTower(**kw)
    model.load_state_dict(convert.language_from_numpy(text=params)["text"])
    with torch.no_grad():
        got = model(torch.as_tensor(tokens))
    assert_normalized(got, ref, 1e-4)


def test_tokenizer_ids_match_jax():
    from online_lang_splatting_tpu.eval.relevancy import NEGATIVES
    from online_lang_splatting_tpu_torch.eval import relevancy

    texts = (["a photo of a cat"] + list(relevancy.NEGATIVES)
             + ["window", "door", "poster", "shelf", "painting", "rug", "mat",
                "wooden floor", "tile floor", "it's a Table-lamp, 2 of them!"])
    assert relevancy.NEGATIVES == NEGATIVES
    got = tokenizer.SimpleTokenizer()(texts)
    np.testing.assert_array_equal(got, jtok.SimpleTokenizer()(texts))
    np.testing.assert_array_equal(got[0, :8], [49406, 320, 1125, 539, 320, 2368, 49407, 0])


def _random_state(model: torch.nn.Module, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) if v.is_floating_point() else v.clone())
            for k, v in model.state_dict().items()}


# The port's module names are the reference checkpoints' with the wrapper
# prefix dropped: open_clip's "visual." for the tower, Lightning's "model."
# for the HR head and the offline AE; the online AE and the text tower
# keep their names.
_ROUND_TRIP = {
    "visual": (lambda: conv.ConvNeXtCLIPVisual(DEPTHS, DIMS, EMBED), "visual.",
               lambda sd: CW.convert_visual(sd, depths=DEPTHS)),
    "hr": (lambda: hr_net.HighResLanguageFeatureNet(32, 16, 8, 40), "model.", CW.convert_hr),
    "ae": (lambda: ae.AutoencoderMLP(ae.ONE_STAGE_ENC, ae.ONE_STAGE_DEC), "model.",
           CW.convert_ae),
    "online_ae": (ae.EncoderDecoderOnline, "",
                  lambda sd: CW.convert_online_ae(sd)["params"]),
    "text": (lambda: TextTower(vocab_size=300, width=64, heads=4, layers=2, embed_dim=32), "",
             lambda sd: CW.convert_text(sd, layers=2, heads=4, width=64)),
}


@pytest.mark.parametrize("name", sorted(_ROUND_TRIP))
def test_language_from_numpy_round_trip(name):
    """reference-layout state_dict -> tools/convert_weights -> port state
    dict gives back every original tensor exactly."""
    make, prefix, to_flax = _ROUND_TRIP[name]
    model = make()
    sd = _random_state(model, 11)
    tree = to_flax({prefix + k: v for k, v in sd.items()})
    back = convert.language_from_numpy(**{name: tree})[name]
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype, k
        assert torch.equal(back[k], v), k
    model.load_state_dict(back)


def test_load_extractor_from_dir(tmp_path, capsys):
    """npz trees as tools/convert_weights.py writes them load into the
    extractor; missing files fall back to random init with a warning."""
    rng = np.random.default_rng(8)
    variables = _ae_vars(rng, ae.TWO_STAGE_ENC, ae.TWO_STAGE_DEC)
    CW._save_tree(tmp_path / "autoencoder.npz", variables)
    config = {"language": {"single_stage": False, "hr_model": False}}
    ex, online = load_extractor_from_dir(tmp_path, config, device="cpu")
    out = capsys.readouterr().out
    assert "clip_visual.npz not found" in out and "hr_net.npz not found" in out
    assert ex.hr is None and isinstance(online, OnlineAETrainer)
    want = convert.language_from_numpy(ae=variables)["ae"]
    for k, v in ex.ae.state_dict().items():
        assert torch.equal(v, want[k]), k
    # Random init keeps the flax scales: layer-scale 1e-6, unit LayerNorm.
    blk = ex.visual.trunk.stages[2].blocks[26]
    assert torch.all(blk.gamma == 1e-6) and torch.all(blk.norm.weight == 1)
    w = ex.visual.trunk.stages[2].blocks[0].mlp.fc1.weight
    np.testing.assert_allclose(float(w.std()), (1 / 768) ** 0.5, rtol=0.05)


def test_incremental_pca_matches_jax():
    rng = np.random.default_rng(10)
    pca, jpca = ae.IncrementalPCA(4), jae.IncrementalPCA(4)
    for _ in range(3):
        x = rng.normal(size=(50, 12)) @ rng.normal(size=(12, 12))
        pca.partial_fit(x)
        jpca.partial_fit(x)
    assert pca.is_fitted and pca.count == jpca.count == 150
    np.testing.assert_allclose(pca.components, jpca.components, atol=1e-12)
    z = pca.transform(x)
    np.testing.assert_allclose(z, jpca.transform(x), atol=1e-12)
    np.testing.assert_allclose(pca.inverse_transform(z), jpca.inverse_transform(z), atol=1e-12)

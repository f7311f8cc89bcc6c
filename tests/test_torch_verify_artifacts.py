"""The port's weight-port tool (tools/verify_artifacts.py) on a fabricated
artifact directory.

Seeded checkpoints in the reference's layouts, at small sizes, with
unhelpful file names, as tests/test_verify_artifacts.py builds them: an
SED pickle (the CLIP towers under `sem_seg_head.predictor.clip_model.`,
with `logit_scale`, an older open_clip's `attn_mask` and SED's
`criterion.empty_weight` beside them; ConvNeXt depths (1, 2, 1, 1), a
2-layer text tower of width 128, so 2 heads), Lightning
{"state_dict", "epoch"} files for the HR head (narrow inputs, no
`num_batches_tracked`, as the reference's fabricated one) and the
autoencoder (with them), a plain online-AE state dict with one float64
tensor, LPIPS's keys, and a foreign pickle. The tool runs once per module
on the CPU.

- Every kind is classified, every npz is written and the tool's own
  parity passes.
- Every npz equals tools/convert_weights.py's output on the same files,
  key for key, dtype and bits.
- The port's models built from the npz match the JAX package's built
  from the same npz, at the JAX tool's tolerances (visual 5e-4 abs / 1e-3
  rel, text 2e-4 / 1e-3, HR 5e-4 of its largest |value|, the
  autoencoders 2e-5 / 1e-4).
- Exit 1 on an empty directory; exit 2, naming the key, when a
  checkpoint lacks one tensor.
"""

import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n

from online_lang_splatting_tpu.models import autoencoder as jae
from online_lang_splatting_tpu.models import checkpoints as jckpt
from online_lang_splatting_tpu.models.convnext_clip import ConvNeXtCLIPVisual as JVisual
from online_lang_splatting_tpu.models.hr_net import HighResLanguageFeatureNet as JHR
from online_lang_splatting_tpu.models.text_tower import TextTower as JText
from online_lang_splatting_tpu_torch import convert
from online_lang_splatting_tpu_torch.eval import lpips
from online_lang_splatting_tpu_torch.models import autoencoder as ae
from online_lang_splatting_tpu_torch.models.checkpoints import load_npz_tree
from online_lang_splatting_tpu_torch.models.convnext_clip import ConvNeXtCLIPVisual
from online_lang_splatting_tpu_torch.models.hr_net import HighResLanguageFeatureNet
from online_lang_splatting_tpu_torch.models.text_tower import TextTower
from online_lang_splatting_tpu_torch.tools import verify_artifacts as VA

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import convert_weights as CW  # noqa: E402

PREFIX = "sem_seg_head.predictor.clip_model."
DEPTHS, DIMS, EMBED = (1, 2, 1, 1), (8, 16, 32, 64), 32
TEXT = dict(vocab_size=300, context_length=12, width=128, heads=2, layers=2, embed_dim=32)
HR_DIMS = (32, 16, 8, 40)
AE_ENC, AE_DEC, AE_CLIP = (24, 12, 6), (12, 24, 48), 48
ONLINE = dict(input_dim=32, compressed_dim=15, hidden=24)
NPZ_FILES = ("clip_visual.npz", "clip_text.npz", "hr_net.npz", "autoencoder.npz",
             "online_ae.npz", "lpips_alex.npz")


def _state(model: torch.nn.Module, g: torch.Generator, prefix: str = "",
           counters: bool = True) -> dict:
    """Seeded tensors in `model`'s layout under `prefix`: weights 0.1 N(0, 1),
    norm scales and variances near 1; BatchNorm's `num_batches_tracked`
    kept or left out."""
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            if counters:
                out[prefix + k] = torch.tensor(7)
            continue
        x = 0.1 * torch.randn(v.shape, generator=g)
        if k.endswith("running_var"):
            x = 1.0 + x.abs()
        out[prefix + k] = x
    return out


def _lpips_state(g: torch.Generator) -> dict:
    sd = {}
    for k, ((o, i, kk, _s, _p), fi) in enumerate(zip(lpips._CONVS, (0, 3, 6, 8, 10))):
        sd[f"net.slice{k + 1}.{fi}.weight"] = 0.1 * torch.randn((o, i, kk, kk), generator=g)
        sd[f"net.slice{k + 1}.{fi}.bias"] = 0.1 * torch.randn(o, generator=g)
        sd[f"lin{k}.model.1.weight"] = torch.rand((1, o, 1, 1), generator=g)
    return sd


def _build_artifact_dir(root: Path) -> Path:
    g = torch.Generator().manual_seed(0)
    art = root / "artifacts"
    (art / "nested").mkdir(parents=True)
    sed = {**_state(ConvNeXtCLIPVisual(DEPTHS, DIMS, EMBED), g, PREFIX + "visual."),
           **_state(TextTower(**TEXT), g, PREFIX)}
    sed[PREFIX + "logit_scale"] = torch.tensor(4.6052)
    sed[PREFIX + "attn_mask"] = torch.full((12, 12), float("-inf")).triu(1)
    sed["criterion.empty_weight"] = torch.zeros(4)
    torch.save(sed, art / "seg_clip_model_l.pth")
    hr = _state(HighResLanguageFeatureNet(*HR_DIMS), g, "model.", counters=False)
    torch.save({"state_dict": hr, "epoch": 9}, art / "epoch=9-step=1.ckpt")
    sd_ae = _state(ae.AutoencoderMLP(AE_ENC, AE_DEC, AE_CLIP), g, "model.")
    torch.save({"state_dict": sd_ae, "epoch": 2}, art / "nested" / "last.ckpt")
    online = _state(ae.EncoderDecoderOnline(**ONLINE), g)
    online["encoder.0.bias"] = online["encoder.0.bias"].double()
    torch.save(online, art / "online_encoder.pth")
    torch.save(_lpips_state(g), art / "weights.pth")
    torch.save({"random": torch.zeros(3)}, art / "unrelated.pt")
    return art


def _run(argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = VA.main([str(a) for a in argv])
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def tool(tmp_path_factory):
    root = tmp_path_factory.mktemp("verify")
    art = _build_artifact_dir(root)
    out = root / "converted"
    rc, stdout = _run(["--dir", art, "--out", out, "--device", "cpu"])
    return dict(art=art, out=out, rc=rc, stdout=stdout)


@pytest.fixture(scope="module")
def reference(tool, tmp_path_factory):
    """tools/convert_weights.py's npz of the same files, at their sizes."""
    out = tmp_path_factory.mktemp("convert_weights")
    art = tool["art"]

    def load(name):
        obj = torch.load(art / name, map_location="cpu", weights_only=False)
        return obj["state_dict"] if "state_dict" in obj else obj

    sed = load("seg_clip_model_l.pth")
    sub = {k.removeprefix(PREFIX): v for k, v in sed.items() if k.startswith(PREFIX)}
    CW._save_tree(out / "clip_visual.npz", CW.convert_visual(sub, depths=DEPTHS))
    CW._save_tree(out / "clip_text.npz", CW.convert_text(
        sub, layers=TEXT["layers"], heads=TEXT["heads"], width=TEXT["width"]))
    CW._save_tree(out / "hr_net.npz", CW.convert_hr(load("epoch=9-step=1.ckpt")))
    CW._save_tree(out / "autoencoder.npz", CW.convert_ae(load("nested/last.ckpt")))
    CW._save_tree(out / "online_ae.npz", CW.convert_online_ae(load("online_encoder.pth")))
    np.savez(out / "lpips_alex.npz", **CW.convert_lpips(load("weights.pth")))
    return out


def test_every_artifact_classified_converted_and_checked(tool):
    assert tool["rc"] == 0, tool["stdout"]
    for kind, name in (("sed", "seg_clip_model_l.pth"), ("hr", "epoch=9-step=1.ckpt"),
                       ("ae", "last.ckpt"), ("online_ae", "online_encoder.pth"),
                       ("lpips", "weights.pth")):
        assert any(line.startswith(f"  {kind:<10} <- ") and line.endswith(name)
                   for line in tool["stdout"].splitlines()), (kind, tool["stdout"])
    assert "skip unrelated.pt: no known key signature" in tool["stdout"]
    for name in NPZ_FILES:
        assert (tool["out"] / name).exists(), name
        assert f"{name}:" in tool["stdout"] and "bit for bit" in tool["stdout"]
    assert tool["stdout"].rstrip().endswith("ALL OK")
    report = json.loads((tool["out"] / "verify_report.json").read_text())
    assert set(report["models"]) == {"visual", "text", "hr", "ae", "online_ae", "lpips"}
    assert all(m["round_trip"] == "bit for bit" for m in report["models"].values())


@pytest.mark.parametrize("name", NPZ_FILES)
def test_npz_bit_equal_to_convert_weights(tool, reference, name):
    with np.load(tool["out"] / name) as got, np.load(reference / name) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if name == "online_ae.npz":  # the checkpoint's float64 tensor kept
        with np.load(tool["out"] / name) as got:
            assert got["params/enc1/bias"].dtype == np.float64


def _close(got, want, atol, rtol, what):
    np.testing.assert_allclose(n(got), np.asarray(want), atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("name", ["visual", "text", "hr", "ae", "online_ae"])
def test_models_from_out_match_jax(tool, name):
    """The port's model built from OUT against the JAX package's built from
    the same npz (reference-exact modes)."""
    out = tool["out"]
    g = np.random.default_rng(10)
    if name == "visual":
        tree = load_npz_tree(out / "clip_visual.npz")
        model = ConvNeXtCLIPVisual(DEPTHS, DIMS, EMBED)
        model.load_state_dict(convert.language_from_numpy(visual=tree)["visual"])
        x = g.normal(size=(1, 3, 64, 64)).astype(np.float32)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x))
        want = JVisual(depths=DEPTHS, dims=DIMS, embed_dim=EMBED, stem_mode="conv",
                       gelu_mode="erf").apply({"params": jckpt.load_npz_tree(out / "clip_visual.npz")},
                                              jnp.asarray(x.transpose(0, 2, 3, 1)))
        for key in ("stem", "res2", "res3", "res4", "res5", "clip_vis_dense"):
            _close(got[key].permute(0, 2, 3, 1), want[key], 5e-4, 1e-3, key)
    elif name == "text":
        from online_lang_splatting_tpu_torch.models.checkpoints import load_text_tower

        tower = load_text_tower(out / "clip_text.npz", "cpu")
        tokens = np.zeros((3, TEXT["context_length"]), np.int64)
        tokens[0, :5] = [1, 100, 200, 250, 299]
        tokens[1, :3] = [1, 40, 299]
        tokens[2, :4] = [5, 17, 123, 299]
        with torch.no_grad():
            got = tower(torch.from_numpy(tokens))
        want = JText(**TEXT).apply({"params": jckpt.load_npz_tree(out / "clip_text.npz")},
                                   jnp.asarray(tokens.astype(np.int32)))
        _close(got, want, 2e-4, 1e-3, "text")
    elif name == "hr":
        model = HighResLanguageFeatureNet(*HR_DIMS)
        model.load_state_dict(convert.language_from_numpy(
            hr=load_npz_tree(out / "hr_net.npz"))["hr"])
        xs = [g.normal(size=s).astype(np.float32)
              for s in ((1, HR_DIMS[0], 6, 6), (1, HR_DIMS[1], 24, 24), (1, HR_DIMS[2], 48, 48))]
        with torch.no_grad():
            got = model.eval()(*map(torch.from_numpy, xs)).permute(0, 2, 3, 1)
        want = np.asarray(JHR(out_channels=HR_DIMS[3]).apply(
            jckpt.load_npz_tree(out / "hr_net.npz"),
            *(jnp.asarray(x.transpose(0, 2, 3, 1)) for x in xs)))
        scale = float(np.abs(want).max())
        _close(got / scale, want / scale, 5e-4, 0.0, "hr")
    elif name == "ae":
        model = ae.AutoencoderMLP(AE_ENC, AE_DEC, AE_CLIP)
        model.load_state_dict(convert.language_from_numpy(
            ae=load_npz_tree(out / "autoencoder.npz"))["ae"])
        x = g.normal(size=(32, AE_CLIP)).astype(np.float32)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x))
        want = jae.AutoencoderMLP(encoder_dims=AE_ENC, decoder_dims=AE_DEC).apply(
            jckpt.load_npz_tree(out / "autoencoder.npz"), jnp.asarray(x))
        _close(got, want, 2e-5, 1e-4, "ae")
    else:
        model = ae.EncoderDecoderOnline(**ONLINE)
        model.load_state_dict(convert.language_from_numpy(
            online_ae=load_npz_tree(out / "online_ae.npz")["params"])["online_ae"])
        x = g.normal(size=(16, ONLINE["input_dim"])).astype(np.float32)
        with torch.no_grad():
            got = model.encode(torch.from_numpy(x))
        want = jae.EncoderDecoderOnline(**ONLINE).apply(
            jckpt.load_npz_tree(out / "online_ae.npz"), jnp.asarray(x), method="encode")
        _close(got, want, 2e-5, 1e-4, "online_ae")


def test_empty_directory_exits_1(tmp_path):
    (tmp_path / "empty").mkdir()
    torch.save({"random": torch.zeros(3)}, tmp_path / "empty" / "x.pt")
    rc, stdout = _run(["--dir", tmp_path / "empty", "--out", tmp_path / "o", "--device", "cpu"])
    assert rc == 1
    assert "no recognizable artifacts found" in stdout


def test_dropped_tensor_exits_nonzero_naming_the_key(tool, tmp_path):
    art = tmp_path / "art"
    shutil.copytree(tool["art"], art)
    ckpt = torch.load(art / "epoch=9-step=1.ckpt", weights_only=False)
    del ckpt["state_dict"]["model.attention_fusion1.fusion.1.running_var"]
    torch.save(ckpt, art / "epoch=9-step=1.ckpt")
    rc, stdout = _run(["--dir", art, "--out", tmp_path / "o", "--device", "cpu"])
    assert rc not in (0, 1), stdout
    failed = [line for line in stdout.splitlines() if line.startswith("FAILED")]
    assert failed and "epoch=9-step=1.ckpt" in stdout
    assert "attention_fusion1.fusion.1.running_var" in stdout
    assert "ALL OK" not in stdout


@pytest.mark.parametrize("keys, kind", [
    (["visual.trunk.stem.0.weight", "token_embedding.weight"], "sed"),  # open_clip, no prefix
    ([PREFIX + "visual.trunk.stem.0.weight", "criterion.empty_weight"], "sed"),
    (["initial_conv.0.weight", "final_conv.weight"], "hr"),  # no Lightning prefix
    (["model.encoder.0.weight", "model.encoder.1.running_mean", "model.decoder.0.weight"], "ae"),
    (["encoder.0.weight", "encoder.2.weight", "decoder.0.weight"], "online_ae"),
    ([f"lin{k}.model.1.weight" for k in range(5)], "lpips"),  # the lpips package's file
    (["random"], None),
])
def test_classify_by_key_signature(keys, kind):
    assert VA.classify(dict.fromkeys(keys, torch.zeros(1))) == kind


def test_skip_parity_converts_only(tool, tmp_path):
    rc, stdout = _run(["--dir", tool["art"], "--out", tmp_path / "o", "--device", "cpu",
                       "--skip-parity"])
    assert rc == 0, stdout
    assert "parity skipped (--skip-parity)" in stdout and "bit for bit" not in stdout
    for name in NPZ_FILES:
        with np.load(tmp_path / "o" / name) as got, np.load(tool["out"] / name) as want:
            assert sorted(got.files) == sorted(want.files), name

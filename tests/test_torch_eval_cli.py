"""The port's evaluation tools against the JAX package's scripts on the
CPU, on smoke.yaml with seeded maps and weights: dim15_recon (+ mesh),
save_semantic_colors_gt -> dim3_recon_gt, dim3_recon, evaluation_3d (and
its LangSplat protocol), the three 2D CLIs, and the mIoU gate tool's row.

The JAX scripts run through their own `main` (loaded by path, `--cpu`),
the port's tools through theirs (`--device cpu`). Both extractors are
light here (the CLIs only decode codes: the towers are never run) and both
text towers are one narrow block with CLIP's vocabulary, read from the
same clip_text.npz. Tolerances: PLY fields <= 1e-5, per-class 3D results
<= 1e-3 relative (Chamfer and EMD in float32, see test_torch_tsdf_eval.py)
with the same point counts, the 2D metrics <= 1e-6, colour PNGs exact.
"""

import ast
import functools
import importlib.util
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from online_lang_splatting_tpu.models import sed as jsed
from online_lang_splatting_tpu.models import text_tower as jtext
from online_lang_splatting_tpu.models.autoencoder import AutoencoderMLP as JAutoencoderMLP
from online_lang_splatting_tpu_torch import convert
from online_lang_splatting_tpu_torch.eval.synthetic_miou import write_annotations
from online_lang_splatting_tpu_torch.models import autoencoder as ae
from online_lang_splatting_tpu_torch.models import sed
from online_lang_splatting_tpu_torch.models.checkpoints import save_npz_tree
from online_lang_splatting_tpu_torch.models.convnext_clip import ConvNeXtCLIPVisual
from online_lang_splatting_tpu_torch.models.hr_net import HighResLanguageFeatureNet
from online_lang_splatting_tpu_torch.models.init import make_generator
from online_lang_splatting_tpu_torch.models.text_tower import TextTower
from online_lang_splatting_tpu_torch.slam.config import load_config
from online_lang_splatting_tpu_torch.slam.datasets import SyntheticDataset
from online_lang_splatting_tpu_torch.tools import (dim3_recon, dim3_recon_gt, dim15_recon,
                                                   evaluate_langslam, evaluate_langsplat,
                                                   evaluate_onlinelangslam, evaluation_3d,
                                                   evaluation_3d_langsplat,
                                                   save_semantic_colors_gt,
                                                   synthetic_miou_gate)
from online_lang_splatting_tpu_torch.utils.ply import read_ply, write_ply
from online_lang_splatting_tpu_torch.utils.png import read_png, read_rgb8, write_png

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import convert_weights as CW  # noqa: E402

SMOKE = str(REPO / "configs/synthetic/smoke.yaml")
LANG_FRAMES = (1, 2, 4, 5, 7)  # frame 7's map is rendered at half size
TEXT = dict(width=32, heads=2, layers=1)  # CLIP's vocabulary and context
VISUAL = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), embed_dim=32)


class _JaxLight(jsed.LangFeatureExtractor):
    """The JAX extractor without its towers: the CLIs only decode codes."""

    def __init__(self, visual_params=None, hr_variables=None, ae_variables=None, *,
                 encoder_dims=None, decoder_dims=None, use_hr=True, **_):
        import jax.numpy as jnp

        self.dtype = self.compute_dtype = jnp.float32
        self.ae = JAutoencoderMLP(encoder_dims=tuple(encoder_dims),
                                  decoder_dims=tuple(decoder_dims))
        self.ae_variables = ae_variables


@pytest.fixture
def light(monkeypatch):
    """Light extractors and the narrow text tower in both packages, and the
    JAX scripts' directories on sys.path (they import their siblings)."""
    monkeypatch.setattr(jsed, "LangFeatureExtractor", _JaxLight)
    monkeypatch.setattr(jtext, "TextTower", functools.partial(jtext.TextTower, **TEXT))
    monkeypatch.setattr(sed, "LangFeatureExtractor",
                        functools.partial(sed.LangFeatureExtractor, **VISUAL))
    for d in ("tsdf-fusion", "eval"):
        monkeypatch.syspath_prepend(str(REPO / d))
    return monkeypatch


@functools.cache
def _script(rel: str):
    spec = importlib.util.spec_from_file_location("jax_cli_" + Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(monkeypatch, rel: str, argv, **kw):
    monkeypatch.setattr(sys, "argv", [rel, *map(str, argv), "--cpu"])
    return _script(rel).main(**kw)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A run directory of seeded 15-d maps, two weights directories (one-
    and two-stage autoencoder, the narrow text tower, the online codec) and
    the synthetic scene's class maps as PNGs."""
    root = tmp_path_factory.mktemp("cli")
    ds = SyntheticDataset(load_config(SMOKE))
    rng = np.random.default_rng(0)
    lang = root / "run" / "before_opt" / "lang"
    lang.mkdir(parents=True)
    for idx in LANG_FRAMES:
        hw = (ds.height // 2, ds.width // 2) if idx == 7 else (ds.height, ds.width)
        np.save(lang / f"{idx:05d}.npy", (rng.normal(size=(15, *hw)) * 0.3).astype(np.float32))
    text = TextTower(**TEXT, generator=make_generator(3))
    for name, enc, dec in (("w1", ae.ONE_STAGE_ENC, ae.ONE_STAGE_DEC),
                           ("w2", ae.TWO_STAGE_ENC, ae.TWO_STAGE_DEC)):
        (root / name).mkdir()
        model = ae.AutoencoderMLP(enc, dec, 768, generator=make_generator(len(enc)))
        save_npz_tree(root / name / "autoencoder.npz", convert.ae_to_numpy(model.state_dict()))
        save_npz_tree(root / name / "clip_text.npz",
                      convert.text_to_numpy(text.state_dict(), TEXT["heads"]))
    online = ae.EncoderDecoderOnline(generator=make_generator(5))
    save_npz_tree(root / "online_ae.npz",
                  {"params": convert.online_ae_to_numpy(online.state_dict())})
    classes = root / "semantic_class"
    classes.mkdir()
    for idx in range(0, len(ds), 2):
        sem = ds.gt_semantics(idx).astype(np.uint16 if idx % 4 else np.uint8)
        write_png(classes / f"semantic_class_{idx}.png", sem)
    ann = write_annotations(types.SimpleNamespace(dataset=ds, labels=list(ds.SEMANTIC_LABELS)),
                            LANG_FRAMES[:4], root / "ann")
    return types.SimpleNamespace(root=root, ds=ds, lang=lang, ann=ann, classes=classes,
                                 labels=list(ds.SEMANTIC_LABELS))


def _read_mesh(path):
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    head = data[:end].decode().splitlines()
    nv = int(next(ln for ln in head if ln.startswith("element vertex")).split()[-1])
    nf = int(next(ln for ln in head if ln.startswith("element face")).split()[-1])
    vt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if "property uchar red" in head:
        vt += [("r", "u1"), ("g", "u1"), ("b", "u1")]
    vt = np.dtype(vt)
    verts = np.frombuffer(data[end:end + nv * vt.itemsize], vt)
    faces = np.frombuffer(data[end + nv * vt.itemsize:], np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    assert len(faces) == nf
    return verts, faces


def _mesh_close(a, b):
    """Faces equal, vertices within 1e-5, colours (features within 1e-5,
    scaled by 255 and truncated) within one step."""
    (v, f), (jv, jf) = _read_mesh(a), _read_mesh(b)
    assert len(f) > 100
    np.testing.assert_array_equal(f, jf)
    for k in "xyz":
        np.testing.assert_allclose(v[k], jv[k], atol=1e-5)
    for k in "rgb":
        assert np.abs(v[k].astype(int) - jv[k].astype(int)).max() <= 1
    return v, f


def _ply_close(a, b):
    """Float fields within 1e-5; uchar colours (features within 1e-5,
    scaled by 255 and truncated) within one step."""
    ra, rb = read_ply(a), read_ply(b)
    assert list(ra) == list(rb)
    for k in ra:
        assert ra[k].dtype == rb[k].dtype and ra[k].shape == rb[k].shape, k
        np.testing.assert_allclose(ra[k].astype(np.float64), rb[k].astype(np.float64),
                                   atol=1 if ra[k].dtype == np.uint8 else 1e-5, err_msg=k)
    return ra


@pytest.mark.parametrize("name", ["visual", "hr", "ae", "text"])
def test_to_numpy_inverts_from_numpy_and_matches_convert_weights(name):
    """The port's state dict -> numpy tree equals tools/convert_weights.py's
    tree of the same weights in the reference layout, and loads back
    exactly."""
    make, prefix, to_flax, to_np = {
        "visual": (lambda: ConvNeXtCLIPVisual((1, 2, 1, 1), (8, 16, 32, 64), 32), "visual.",
                   lambda sd: CW.convert_visual(sd, depths=(1, 2, 1, 1)), convert.visual_to_numpy),
        "hr": (lambda: HighResLanguageFeatureNet(32, 16, 8, 40), "model.", CW.convert_hr,
               convert.hr_to_numpy),
        "ae": (lambda: ae.AutoencoderMLP(ae.ONE_STAGE_ENC, ae.ONE_STAGE_DEC), "model.",
               CW.convert_ae, convert.ae_to_numpy),
        "text": (lambda: TextTower(vocab_size=300, width=64, heads=4, layers=2, embed_dim=32), "",
                 lambda sd: CW.convert_text(sd, layers=2, heads=4, width=64),
                 lambda sd: convert.text_to_numpy(sd, 4)),
    }[name]
    g = torch.Generator().manual_seed(7)
    sd = {k: (torch.randn(v.shape, generator=g) if v.is_floating_point() else v.clone())
          for k, v in make().state_dict().items()}
    tree, ref = to_np(sd), to_flax({prefix + k: v for k, v in sd.items()})

    def flat(node, pre=""):
        if isinstance(node, dict):
            return {k2: v2 for k, v in node.items() for k2, v2 in flat(v, f"{pre}/{k}").items()}
        return {pre: np.asarray(node)}

    ft, fr = flat(tree), flat(ref)
    assert set(ft) == set(fr)
    for k in fr:
        np.testing.assert_array_equal(ft[k], fr[k], err_msg=k)
    back = convert.language_from_numpy(**{name: tree})[name]
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_png_round_trip(tmp_path):
    import cv2

    rng = np.random.default_rng(4)
    for img in (rng.integers(0, 256, (9, 13, 3), dtype=np.uint8),
                rng.integers(0, 256, (9, 13), dtype=np.uint8),
                rng.integers(0, 65536, (9, 13), dtype=np.uint16)):
        write_png(tmp_path / "a.png", img)
        got = read_png(tmp_path / "a.png")
        assert got.dtype == img.dtype or got.dtype.newbyteorder("=") == img.dtype
        np.testing.assert_array_equal(got, img)
        ref = cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(ref[..., ::-1] if img.ndim == 3 else ref, img)
        if img.dtype == np.uint8:
            np.testing.assert_array_equal(
                read_rgb8(tmp_path / "a.png"),
                cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_COLOR)[..., ::-1])


def test_dim15_recon_matches_jax(scene, light, tmp_path):
    argv = ["--run-dir", scene.root / "run", "--dataset-config", SMOKE, "--voxel", "0.1",
            "--mesh"]
    (tmp_path / "j").mkdir()
    _jax_main(light, "tsdf-fusion/dim15_recon.py", [*argv, "--out", tmp_path / "j" / "pc.ply"])
    got = dim15_recon.main([*map(str, argv), "--out", str(tmp_path / "pc.ply"), "--device", "cpu"])
    assert got["frames"] == list(LANG_FRAMES) and got["points"] > 1000
    fields = _ply_close(tmp_path / "pc.ply", tmp_path / "j" / "pc.ply")
    assert [k for k in fields if k.startswith("f_")] == [f"f_{j}" for j in range(15)]
    v, _ = _mesh_close(tmp_path / "semantic_mesh.ply", tmp_path / "j" / "semantic_mesh.ply")
    assert len(v) == got["verts"]


def test_colors_and_gt_recon_match_jax(scene, light, tmp_path):
    for out, run in ((tmp_path / "j" / "color", "jax"), (tmp_path / "p" / "color", "port")):
        argv = ["--semantic-class-dir", scene.classes, "--out", out, "--num-classes", "20"]
        if run == "jax":
            light.setattr(sys, "argv", ["save_semantic_colors_gt.py", *map(str, argv)])
            _script("tsdf-fusion/save_semantic_colors_gt.py").main()
        else:
            save_semantic_colors_gt.main(list(map(str, argv)))
    np.testing.assert_array_equal(np.load(tmp_path / "p" / "color_code.npy"),
                                  np.load(tmp_path / "j" / "color_code.npy"))
    names = sorted(p.name for p in (tmp_path / "j" / "color").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "p" / "color").glob("*.png"))
    assert len(names) == 6
    for name in names:
        np.testing.assert_array_equal(read_rgb8(tmp_path / "p" / "color" / name),
                                      read_rgb8(tmp_path / "j" / "color" / name))

    for side in ("j", "p"):
        argv = ["--semantic-color-dir", tmp_path / side / "color", "--dataset-config", SMOKE,
                "--voxel", "0.1", "--every", "2", "--out", tmp_path / side / "gt"]
        if side == "j":
            _jax_main(light, "tsdf-fusion/dim3_recon_gt.py", argv)
        else:
            got = dim3_recon_gt.main([*map(str, argv), "--device", "cpu"])
    assert got["points"] > 1000
    _ply_close(tmp_path / "p" / "gt" / "GT_semantic_pc.ply",
               tmp_path / "j" / "gt" / "GT_semantic_pc.ply")
    assert (tmp_path / "p" / "gt" / "GT_semantic_mesh.ply").read_bytes() == \
        (tmp_path / "j" / "gt" / "GT_semantic_mesh.ply").read_bytes()


def test_dim3_recon_npy_maps_match_jax(scene, light, tmp_path):
    """(H, W, 3) .npy maps at another size: nearest-neighbour resize as
    cv2's INTER_NEAREST."""
    rng = np.random.default_rng(6)
    maps = tmp_path / "maps"
    maps.mkdir()
    for idx in range(0, 8, 2):
        np.save(maps / f"render_{idx}.npy",
                rng.uniform(size=(scene.ds.height * 3 // 4, scene.ds.width * 5 // 8, 3))
                .astype(np.float32))
    argv = ["--color-dir", maps, "--dataset-config", SMOKE, "--voxel", "0.1", "--every", "1"]
    _jax_main(light, "tsdf-fusion/dim3_recon.py", [*argv, "--out", tmp_path / "j"])
    dim3_recon.main([*map(str, argv), "--out", str(tmp_path / "p"), "--device", "cpu"])
    _ply_close(tmp_path / "p" / "semantic_pc.ply", tmp_path / "j" / "semantic_pc.ply")
    _mesh_close(tmp_path / "p" / "semantic_mesh.ply", tmp_path / "j" / "semantic_mesh.ply")


def _pred_and_gt(scene, tmp_path, pad: bool):
    """A predicted cloud with 15-d codes (column names f_00 .. f_14 when
    `pad`, which both packages read in channel order) and a labelled GT
    cloud of the same surface, jittered."""
    rng = np.random.default_rng(9)
    pts = (rng.uniform(-1, 1, (1500, 3)) + [0.0, 0.0, 3.0]).astype(np.float32)
    codes = (rng.normal(size=(1500, 15)) * 0.3).astype(np.float32)
    fields = {c: pts[:, j] for j, c in enumerate("xyz")}
    fields.update({(f"f_{j:02d}" if pad else f"f_{j}"): codes[:, j] for j in range(15)})
    write_ply(tmp_path / f"pred{pad}.ply", fields)
    gt = (pts + rng.normal(size=pts.shape) * 0.01).astype(np.float32)
    write_ply(tmp_path / "gt.ply", {"x": gt[:, 0], "y": gt[:, 1], "z": gt[:, 2],
                                    "label": rng.integers(0, 4, 1500).astype(np.int32)})
    return tmp_path / f"pred{pad}.ply", tmp_path / "gt.ply"


@pytest.mark.parametrize("protocol", ["langslam", "online", "langsplat"])
def test_evaluation_3d_matches_jax(scene, light, tmp_path, protocol):
    pred, gt = _pred_and_gt(scene, tmp_path, pad=True)
    weights = scene.root / ("w2" if protocol == "online" else "w1")
    argv = ["--pred", pred, "--gt", gt, "--classes", ",".join(scene.labels[:4]),
            "--weights-dir", weights, "--max-points", "200"]
    if protocol == "online":
        argv += ["--online-ae", scene.root / "online_ae.npz"]
    if protocol == "langsplat":
        _jax_main(light, "tsdf-fusion/evaluation_3d.py",
                  [*argv, "--with-negatives", "--out", tmp_path / "j.json"])
        got = evaluation_3d_langsplat.main([*map(str, argv), "--device", "cpu"])
    else:
        _jax_main(light, "tsdf-fusion/evaluation_3d.py", [*argv, "--out", tmp_path / "j.json"])
        got = evaluation_3d.main([*map(str, argv), "--device", "cpu",
                                  "--out", str(tmp_path / "p.json")])
        assert json.loads((tmp_path / "p.json").read_text()) == json.loads(json.dumps(got))
    ref = json.loads((tmp_path / "j.json").read_text())
    assert list(got) == list(ref)
    assert list(got["per_class"]) == list(ref["per_class"]) and got["per_class"]
    for name, r in ref["per_class"].items():
        g = got["per_class"][name]
        assert list(g) == list(r)
        assert (g["n_pred"], g["n_gt"]) == (r["n_pred"], r["n_gt"])
        np.testing.assert_allclose([g["chamfer"], g["emd"]], [r["chamfer"], r["emd"]], rtol=1e-3)
    np.testing.assert_allclose([got["mean_chamfer"], got["mean_emd"]],
                               [ref["mean_chamfer"], ref["mean_emd"]], rtol=1e-3)


def test_evaluation_3d_reads_channels_in_order(scene, light, tmp_path):
    """f_0 .. f_14 columns are read in channel order (a name sort would put
    f_10 before f_2): the same result as the zero-padded names."""
    argv = ["--classes", ",".join(scene.labels[:4]), "--weights-dir", str(scene.root / "w1"),
            "--device", "cpu", "--max-points", "100"]
    a = evaluation_3d.main(["--pred", str(_pred_and_gt(scene, tmp_path, pad=False)[0]),
                            "--gt", str(tmp_path / "gt.ply"), *argv])
    b = evaluation_3d.main(["--pred", str(_pred_and_gt(scene, tmp_path, pad=True)[0]),
                            "--gt", str(tmp_path / "gt.ply"), *argv])
    assert a == b


@pytest.mark.parametrize("cli", ["langslam", "online", "langsplat"])
def test_2d_clis_match_jax(scene, light, tmp_path, cli):
    size = ["--eval-h", str(scene.ds.height), "--eval-w", str(scene.ds.width)]
    if cli == "langsplat":
        argv = ["--feat-dirs", *[str(scene.lang)] * 3, "--ann", str(scene.ann), "--chw",
                "--weights-dir", str(scene.root / "w1"), *size]
        ref = _jax_main(light, "eval/evaluate_langsplat.py", argv)
        got = evaluate_langsplat.main([*argv, "--device", "cpu"])
    else:
        argv = ["--feat-dir", str(scene.lang), "--ann", str(scene.ann), *size]
        if cli == "online":
            argv += ["--weights-dir", str(scene.root / "w2"),
                     "--online-ae", str(scene.root / "online_ae.npz")]
            ref = _jax_main(light, "eval/evaluate_onlinelangslam.py", argv)
            got = evaluate_onlinelangslam.main([*argv, "--device", "cpu",
                                                "--out", str(tmp_path / "m.json")])
            assert json.loads((tmp_path / "m.json").read_text()) == got
        else:
            argv += ["--weights-dir", str(scene.root / "w1")]
            ref = _jax_main(light, "eval/evaluate_langslam.py", argv, single_stage=True)
            got = evaluate_langslam.main([*argv, "--device", "cpu"])
    assert list(got) == list(ref)
    assert got["frames_scored"] == 4 and got["num_queries"] > 4
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, err_msg=k)


def test_entry_points_need_the_card_unless_asked(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        dim15_recon.main(["--run-dir", str(scene.root / "run"), "--dataset-config", SMOKE])


def _update_keys(path: str) -> list:
    """The keyword names of `result.update(...)` calls in a source file."""
    return [kw.arg for node in ast.walk(ast.parse((REPO / path).read_text()))
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "update"
            and getattr(node.func.value, "id", "") == "result" for kw in node.keywords]


def test_miou_gate_row_has_the_jax_tools_keys(tmp_path, capsys):
    rc = synthetic_miou_gate.main(["--max-frames", "6", "--every", "2", "--ae-steps", "20",
                                   "--device", "cpu", "--no-gates",
                                   "--out", str(tmp_path / "rows.jsonl")])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row == json.loads((tmp_path / "rows.jsonl").read_text())
    scene_keys = ["miou", "localization_acc", "num_queries", "distinct_queries", "frames_scored"]
    jax_keys = (scene_keys + _update_keys("online_lang_splatting_tpu/eval/synthetic_miou.py")
                + _update_keys("tools/synthetic_miou_gate.py") + ["gates_ok"])
    assert set(jax_keys) <= set(row)
    assert row["device"] == "cpu" and row["stage"] == 2 and list(row)[-2:] == ["device",
                                                                              "gates_ok"]
    assert np.isfinite(row["miou"]) and row["frames_scored"] >= 1

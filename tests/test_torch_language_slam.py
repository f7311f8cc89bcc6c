"""The language slice of the port as a whole, on the CPU at smoke size.

1. One mapping iteration of the port's backend with two-stage language
   supervision (extractor codes -> online AE -> 15-d maps) against the JAX
   package's mapping iteration fed the same codes through its own online
   AE, with the JAX backend's own random picks and online-AE replay: the
   Gaussian language params and the online-AE params agree within 2e-3.
2. The online-AE step count of a full run equals the reference schedule
   (one step per keyframe extraction, per 5th init iteration other than 0,
   per random keyframe visit), within the bounds
   tests/test_lang_integration.py puts on the JAX package.
3. The port's run_synthetic_miou (stage 2, 12 frames, feat_hw 24) meets the
   JAX package's pinned smoke locks (tests/test_synthetic_miou.py), and the
   rendered language maps moved toward their non-zero supervision.
4. The online codec through a replica-scale run's step schedule on the
   9-class scene's codes gives the JAX package's targets and classes.

Tile 16 on both sides, as in tests/test_torch_slam.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import jax_params_aux, map_from_frame, n, t

from online_lang_splatting_tpu.models import checkpoints as jcheckpoints
from online_lang_splatting_tpu.models import gaussians as JG
from online_lang_splatting_tpu.ops.raster import RasterSettings as JSettings
from online_lang_splatting_tpu.slam import backend as jbackend
from online_lang_splatting_tpu.slam import camera as jcamera
from online_lang_splatting_tpu.slam import datasets as jdatasets
from online_lang_splatting_tpu_torch import convert
from online_lang_splatting_tpu_torch.convert import gaussians_from_numpy
from online_lang_splatting_tpu_torch.eval.synthetic_miou import run_synthetic_miou
from online_lang_splatting_tpu_torch.models.checkpoints import OnlineAETrainer
from online_lang_splatting_tpu_torch.ops import graphics
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings
from online_lang_splatting_tpu_torch.slam import backend, camera, datasets, renderer
from online_lang_splatting_tpu_torch.slam.config import load_config
from online_lang_splatting_tpu_torch.slam.system import SLAM

SMOKE = "configs/synthetic/smoke.yaml"
LANG_HW = (24, 24)


def _two_stage_config():
    cfg = load_config(SMOKE)
    cfg["language"].update(single_stage=False, feat_hw=LANG_HW[0],
                           allow_zero_supervision=False)
    cfg["raster_tile"] = 16
    return cfg


class _CodeStub:
    """A 32-d code map that is a fixed function of the frame, computable
    from numpy on the JAX side and from the camera tensor on the port's."""

    W = np.random.default_rng(9).normal(size=(6, 32)).astype(np.float32)

    @classmethod
    def codes(cls, rgb_hwc_255: np.ndarray) -> np.ndarray:
        h, w, _ = rgb_hwc_255.shape
        ys = np.arange(LANG_HW[0]) * h // LANG_HW[0]
        xs = np.arange(LANG_HW[1]) * w // LANG_HW[1]
        x = rgb_hwc_255[np.ix_(ys, xs)] / 255.0
        z = np.concatenate([x, x * x], axis=-1) @ cls.W + 0.1
        return (z / np.linalg.norm(z, axis=-1, keepdims=True)).astype(np.float32)

    def encode_frame(self, rgb):
        return torch.as_tensor(self.codes(n(rgb)))


def test_mapping_iteration_with_online_ae_matches_jax():
    cfg = _two_stage_config()
    ds, jds = datasets.SyntheticDataset(cfg), jdatasets.SyntheticDataset(cfg)
    w, h = ds.width, ds.height
    kfs, window, count0 = [0, 3, 6, 9, 11], [11, 9, 6], 40
    proj = graphics.projection_matrix(0.01, 100.0, ds.cx, ds.cy, ds.fx, ds.fy, w, h)
    kw = dict(image_height=h, image_width=w, tanfovx=np.tan(ds.fovx / 2),
              tanfovy=np.tan(ds.fovy / 2), sh_degree=0, tile=16)
    tree = map_from_frame(ds, frame=6, n_pts=400)

    # JAX: its online AE trainer, frame stack, random picks and replay.
    jtrainer = jcheckpoints.OnlineAETrainer()
    jbe = jbackend.BackEnd(cfg, JSettings(backend="oracle", **kw), n(proj), capacity=1024,
                           online_ae=jtrainer)
    trainer = OnlineAETrainer(device="cpu")
    trainer.model.load_state_dict(convert.language_from_numpy(
        online_ae={k: {kk: np.asarray(vv) for kk, vv in v.items()}
                   for k, v in jtrainer.params.items()})["online_ae"])
    jbe.frame_stack = jfs = jbackend.FrameStack(h, w, 15, cap=16, lang_hw=LANG_HW)
    langs = {}
    for idx in kfs:
        color, depth, pose, _, _ = jds[idx]
        jcam = jcamera.Camera.from_dataset(jds, idx)
        jcam.update_rt(pose[:3, :3], pose[:3, 3])
        jbe.viewpoints[idx] = jcam
        jfs.add(idx, jnp.asarray(color), depth)
        codes32 = _CodeStub.codes(color.transpose(1, 2, 0) * np.float32(255.0)).reshape(-1, 32)
        code15 = jtrainer.train_and_encode(jnp.asarray(codes32))
        langs[idx] = np.asarray(code15).reshape(LANG_HW + (15,)).transpose(2, 0, 1)
        jfs.set_lang(idx, jnp.asarray(langs[idx]))
        jfs.set_coco(idx, codes32)
    rand_pool = [i for i in jbe.viewpoints if i not in window]
    _, (rows_h, valid_h) = jbe._stage_rand(rand_pool, count0, 1)
    kf_of_row = {r: k for k, r in jfs.row_of.items()}
    picks = [kf_of_row[int(r)] for r, v in zip(rows_h[0], valid_h[0]) if v]
    assert len(picks) == 2

    # The port: its backend end to end from extraction to the replay.
    be = backend.BackEnd(cfg, RasterSettings(backend="cuda", **kw), proj, "cpu",
                         capacity=1024, lang_extractor=_CodeStub(), online_ae=trainer)
    be.params, be.aux, be.opt = gaussians_from_numpy(tree)
    for idx in kfs:
        cam = camera.Camera.from_dataset(ds, idx, "cpu")
        cam.update_rt(cam.r_gt, cam.t_gt)
        be.viewpoints[idx] = cam
        be.frame_stack.add(idx, cam.image, cam.depth)
        be.ensure_lang_features(cam)
        np.testing.assert_allclose(n(be.frame_stack.langs[idx]), langs[idx], atol=1e-5)
    be.iteration_count = count0
    lrs = be._lrs(float(count0 + 1))
    be.map(window, iters=1, lang_run=True)

    slot_ids = window + [None] + picks
    valid = np.array([i is not None for i in slot_ids])
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    poses = [jds[i][2] if i is not None else None for i in slot_ids]
    slot_r = np.stack([p[:3, :3] if p is not None else eye for p in poses])
    slot_t = np.stack([p[:3, 3] if p is not None else zero for p in poses])
    images = np.stack([jds[i][0] if i is not None else np.zeros((3, h, w), np.float32)
                       for i in slot_ids])
    depths = np.stack([jds[i][1][None] if i is not None else np.zeros((1, h, w), np.float32)
                       for i in slot_ids])
    lang = np.stack([langs[i] if i is not None else np.zeros((15,) + LANG_HW, np.float32)
                     for i in slot_ids])
    s = len(slot_ids)
    opt_mask = np.array([True] * 3 + [False] * 3)
    jp, ja = jax_params_aux(tree)
    zeros = tuple(jnp.zeros(sh, jnp.float32) for sh in ((s, 3), (s, 3), (s,), (s,)))
    ref = jbackend.mapping_iteration(
        jp, JG.init_adam(jp), ja, jnp.asarray(n(proj)), jnp.asarray(slot_r),
        jnp.asarray(slot_t), jnp.zeros(s), jnp.zeros(s), zeros, zeros, jnp.zeros(s),
        *map(jnp.asarray, (images, depths, lang, valid, valid, opt_mask, opt_mask)),
        JG.LearningRates(*(jnp.asarray(n(x)) for x in lrs)), jnp.float32(1.0),
        settings=JSettings(backend="oracle", **kw), n_slots=s, init_mode=False)
    jbe._replay_online_ae(window, (rows_h, valid_h), count0, 1, True, False)

    got_lang, ref_lang = n(be.params.language), np.asarray(ref[0].language)
    np.testing.assert_allclose(got_lang, ref_lang, atol=2e-3)
    assert np.abs(ref_lang - tree["language"]).max() > 1e-3  # the iteration moved them
    assert trainer.step_count == jtrainer.step_count == len(kfs) + 2
    want = convert.language_from_numpy(online_ae={
        k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jtrainer.params.items()})
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(n(v), n(want["online_ae"][k]), atol=2e-3, err_msg=k)


def test_online_codec_schedule_matches_jax():
    """The online codec through a replica-scale run's schedule (keyframes
    0, 4, 8, 11; 1050 init iterations, so 209 init steps on keyframe 0's
    codes; no random visits while the window holds every keyframe), fed
    the same 32-d codes of the 9-class scene from the same initial params.
    Each keyframe's 15-d target is encoded once, at its extraction, and
    decoded by the final codec, in both packages: the classes the decoded
    targets give agree, and the targets and final params agree within 1e-2
    (213 Adam steps on one batch carry float rounding up to ~7e-3 here;
    five steps stay within 1e-5, test_torch_language_models.py)."""
    from online_lang_splatting_tpu.eval.synthetic_miou import SyntheticLangExtractor

    cfg = _two_stage_config()
    cfg["Dataset"]["semantic_classes"] = 9
    jds = jdatasets.SyntheticDataset(cfg)
    ex = SyntheticLangExtractor(jds, lang_hw=LANG_HW, stage=2)
    kfs, init_steps = [0, 4, 8, 11], len(range(5, 1050, 5))
    codes = {k: np.asarray(ex.encode_frame(jds[k][0].transpose(1, 2, 0) * np.float32(255.0)))
             .reshape(-1, 32) for k in kfs}

    jtrainer = jcheckpoints.OnlineAETrainer()
    trainer = OnlineAETrainer(device="cpu")
    trainer.model.load_state_dict(convert.language_from_numpy(online_ae={
        k: {kk: np.asarray(vv) for kk, vv in v.items()}
        for k, v in jtrainer.params.items()})["online_ae"])
    jtargets, targets = {}, {}
    for k in kfs:
        jtargets[k] = np.asarray(jtrainer.train_and_encode(jnp.asarray(codes[k])))
        targets[k] = n(trainer.train_and_encode(t(codes[k])))
        if k == 0:
            jtrainer.train_rows([0] * init_steps, jnp.asarray(codes[0])[None])
            trainer.train_rows([0] * init_steps, {0: t(codes[0])})
    assert trainer.step_count == jtrainer.step_count == len(kfs) + init_steps

    want = convert.language_from_numpy(online_ae={
        k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jtrainer.params.items()})
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(n(v), n(want["online_ae"][k]), atol=1e-2, err_msg=k)

    def classes(z32):
        return np.argmax(np.asarray(ex.decode_codes(jnp.asarray(z32))) @ ex.class_embeds.T, -1)

    stale_acc = []
    for k in kfs:
        np.testing.assert_allclose(targets[k], jtargets[k], atol=1e-2, err_msg=str(k))
        got = classes(n(trainer.decode(t(targets[k]))))
        ref = classes(np.asarray(jtrainer.decode(jnp.asarray(jtargets[k]))))
        assert np.mean(got != ref) <= 0.01, k
        stale_acc.append(np.mean(ref == ex.class_map(k).reshape(-1)))
    # Keyframe 0's target was encoded after one step: the final codec
    # decodes it worse than the 32-d codes it came from.
    assert stale_acc[0] < np.mean(classes(codes[0]) == ex.class_map(0).reshape(-1))


@pytest.fixture(scope="module")
def miou_run(tmp_path_factory):
    """One run_synthetic_miou on smoke.yaml, stage 2, 12 frames, recording
    each BackEnd.map call and keeping the SLAM object."""
    calls, slams = [], []
    orig_map, orig_run = backend.BackEnd.map, SLAM.run_single_thread

    def recording_map(self, window, iters=1, lang_run=False, prune=False, init_mode=False):
        pool = [i for i in self.viewpoints if i not in set(window)]
        calls.append(dict(iters=iters, lang_run=lang_run, prune=prune, init_mode=init_mode,
                          n_pool=len(pool), count0=self.iteration_count))
        return orig_map(self, window, iters, lang_run, prune, init_mode)

    def recording_run(self, max_frames=None):
        slams.append(self)
        return orig_run(self, max_frames)

    out_dir = tmp_path_factory.mktemp("miou")
    cfg = _two_stage_config()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(backend.BackEnd, "map", recording_map)
        mp.setattr(SLAM, "run_single_thread", recording_run)
        res = run_synthetic_miou(cfg, max_frames=12, every=3, stage=2, train_steps=300,
                                 out_dir=out_dir, device="cpu")
    return res, slams[0], calls, out_dir


def test_online_ae_step_count_matches_reference_schedule(miou_run):
    res, slam, calls, _ = miou_run
    be = slam.backend
    online_ae = be.online_ae
    n_kf = len(be.viewpoints)
    init = [c for c in calls if c["init_mode"]]
    assert len(init) == 1 and init[0]["count0"] == 0
    init_itr = init[0]["iters"]
    init_steps = len([i for i in range(init_itr) if i % 5 == 0 and i != 0])
    visits = sum(c["iters"] * min(2, c["n_pool"]) for c in calls
                 if c["lang_run"] and not c["prune"] and not c["init_mode"])
    assert online_ae.step_count == res["online_ae_steps"] == n_kf + init_steps + visits
    assert visits > 0
    # tests/test_lang_integration.py's bounds on the JAX package.
    assert n_kf + init_steps <= online_ae.step_count <= n_kf + init_steps + 2 * be.iteration_count
    hist = np.array([float(x) for x in online_ae.loss_history])
    assert len(hist) == online_ae.step_count
    k = max(3, len(hist) // 5)
    assert hist[-k:].mean() < hist[:k].mean()


def test_synthetic_miou_smoke_locks(miou_run):
    res, _, _, out_dir = miou_run
    # tests/test_synthetic_miou.py's pinned locks.
    assert res["num_queries"] >= 4
    assert res["frames_evaluated"] >= 2
    assert res["ae_roundtrip_cos"] > 0.98
    assert res["miou"] >= 0.35, res
    assert res["localization_acc"] >= 0.75, res
    assert res["multilevel"]["num_queries"] == res["num_queries"]
    assert (out_dir / "ann" / "ann.json").exists()
    assert list((out_dir / "miou" / "lang").glob("*.npy"))
    assert np.isfinite(res["eval_psnr"])


def test_rendered_language_moves_toward_supervision(miou_run):
    """tests/test_lang_integration.py's check: the rendered map of the
    first keyframe is closer to its supervision than zeros are."""
    _, slam, _, _ = miou_run
    be = slam.backend
    idx = sorted(be.viewpoints)[0]
    sup = be.frame_stack.langs[idx]
    assert float(sup.abs().max()) > 1e-3
    cam = be.viewpoints[idx]
    with torch.no_grad():
        out = renderer.render(renderer.activate(be.params, be.aux.active),
                              t(cam.world_view_transform), slam.proj, slam.settings)
    gt = backend.resize_bilinear(sup, (cam.height, cam.width))
    err = float((out.language - gt).abs().mean())
    assert np.isfinite(err) and err < 0.8 * float(gt.abs().mean()), err

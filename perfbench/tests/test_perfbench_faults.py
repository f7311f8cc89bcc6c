"""The check against faults planted under a run: the rest of a run (the
card's look skipped, the CPU and the cells cut small) with the timed path
broken underneath comes out not correct, once for each fault the cell
can have: a step that leaves its state unchanged (tracking, mapping, the
extractor), and an answer altered where it is produced (a render, a
gradient, a language code). (Neither cell has a batch or an exchange between
cards.)"""

import time

import pytest
import torch

from perfbench.harness import common, slam_cell, stream_cell
from perfbench.tests import small

SEED, FRAMES = 2**31 + 11, 7


def _slam():
    """The small SLAM run tracks with the program's ground-truth-pose path
    (`use_gt_pose`): at 96 x 64 tracking resolves rotation only to ~1e-2
    rad, so a sound run reads ~0 and a tracking fault reads the motion it
    left out."""
    torch.set_num_threads(2)
    c = small.cell("slam_replicav2_lang15.orbit", frames=FRAMES + 2, trajectory_frames=30)
    c["config"]["slam"]["Training"]["use_gt_pose"] = True
    out = slam_cell.run(c, SEED, 1e9, False, time.time(), device="cpu",
                        should_stop=lambda idx: idx > FRAMES)
    ok, check = common.judge(out["numbers"], c["limits"])
    return ok and out["failed"] == 0, out["numbers"]


def _stream():
    torch.set_num_threads(2)
    c = small.cell("sed_convnext_l_768.stream", sample_every=2)
    out = stream_cell.run(c, SEED, 1e9, False, time.time(), device="cpu", max_frames=6)
    ok, _ = common.judge(out["numbers"], c["limits"])
    return ok and out["failed"] == 0, out["numbers"]


@pytest.fixture(scope="module")
def sound():
    return {"slam": _slam(), "stream": _stream()}


def test_sound_runs_are_correct(sound):
    for ok, numbers in sound.values():
        assert ok, numbers
    assert sound["slam"][1]["lang_code_err"] is not None  # a keyframe in the window
    assert sound["slam"][1]["map_step_err"] is not None  # and its mapping


def test_tracking_that_leaves_the_pose_unchanged(sound, monkeypatch):
    from online_lang_splatting_tpu_torch.slam.frontend import FrontEnd

    track = FrontEnd.track

    def frozen(self, cam, prev, proj, prev2=None):
        vis = track(self, cam, prev, proj, prev2=prev2)
        cam.update_rt(prev.r, prev.t)
        return vis

    monkeypatch.setattr(FrontEnd, "track", frozen)
    ok, numbers = _slam()
    assert not ok
    assert numbers["pose_rot_err_rad"] > 100 * sound["slam"][1]["pose_rot_err_rad"]


def test_a_render_altered_where_it_is_produced(sound, monkeypatch):
    from online_lang_splatting_tpu_torch.ops.raster import tiled

    forward = tiled.blend_forward

    def altered(*args, **kw):
        img, *rest = forward(*args, **kw)
        return (img * 1.01, *rest)

    monkeypatch.setattr(tiled, "blend_forward", altered)
    ok, numbers = _slam()
    assert not ok
    assert numbers["render_rel_err"] > 100 * sound["slam"][1]["render_rel_err"]


def test_mapping_that_leaves_the_map_unchanged(sound, monkeypatch):
    """Each mapping iteration after the map's initialisation computes its
    gradients and then returns the map it was given."""
    from online_lang_splatting_tpu_torch.slam import backend

    iteration = backend.mapping_iteration

    def unchanged(params, *args, **kw):
        out = iteration(params, *args, **kw)
        return out if kw["init_mode"] else (params, *out[1:])

    monkeypatch.setattr(backend, "mapping_iteration", unchanged)
    ok, numbers = _slam()
    assert not ok
    assert numbers["map_step_err"] > 0.9


def test_a_blend_gradient_altered_where_it_is_produced(sound, monkeypatch):
    """The blend backward's feature gradients, which only mapping's
    gradients read in the check, off by 5 %."""
    from online_lang_splatting_tpu_torch.ops.raster import tiled

    backward = tiled.blend_backward

    def altered(*args, **kw):
        d_geom, d_feat = backward(*args, **kw)
        return d_geom, d_feat * 1.05

    monkeypatch.setattr(tiled, "blend_backward", altered)
    ok, numbers = _slam()
    assert not ok
    assert numbers["map_grad_err"] > 10 * sound["slam"][1]["map_grad_err"]


@pytest.mark.parametrize("fault", ["stale", "altered"])
def test_extractor_faults(sound, monkeypatch, fault):
    """`stale`: the extractor returns its first answer again (its state
    unchanged); `altered`: each answer perturbed where it is produced."""
    from online_lang_splatting_tpu_torch.models.sed import LangFeatureExtractor

    encode = LangFeatureExtractor.encode_frame
    first = {}

    def broken(self, rgb):
        code = encode(self, rgb)
        if fault == "stale":
            return first.setdefault("code", code)
        return code + 0.01 * torch.roll(code, 1, dims=-1)

    monkeypatch.setattr(LangFeatureExtractor, "encode_frame", broken)
    ok, numbers = _stream()
    assert not ok
    assert numbers["code_err"] > 100 * sound["stream"][1]["code_err"]
    first.clear()
    ok, numbers = _slam()
    assert not ok
    assert numbers["lang_code_err"] > 100 * sound["slam"][1]["lang_code_err"]

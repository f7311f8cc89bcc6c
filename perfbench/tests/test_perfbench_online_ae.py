"""The SLAM cell with the configuration's two-stage language codec (the
online 32 -> 15 autoencoder trained during SLAM), on the CPU at a small
size: a sound run is correct and reports the codec's two numbers; faults
planted in the codec's step read at least ten times the largest sound
reading on three seeds; and a one-stage run's check keeps its keys."""

import time

import pytest
import torch

from perfbench.harness import common, slam_cell
from perfbench.tests import small

SEEDS = (2**31 + 61, 2**31 + 62, 2**31 + 63)
FRAMES = 5
ONLINE = ("online_ae_step_err", "online_code_err")


def _run(c, seed):
    torch.set_num_threads(2)
    c["config"]["slam"]["Training"]["use_gt_pose"] = True
    out = slam_cell.run(c, seed, 1e9, False, time.time(), device="cpu",
                        should_stop=lambda idx: idx > FRAMES)
    ok, check = common.judge(out["numbers"], c["limits"])
    return ok and out["failed"] == 0, out["numbers"], check


def _two_stage(seed):
    return _run(small.two_stage(frames=FRAMES + 2, trajectory_frames=30), seed)


@pytest.fixture(scope="module")
def sound():
    return [_two_stage(seed) for seed in SEEDS]


def test_a_sound_two_stage_run_is_correct(sound):
    for ok, numbers, check in sound:
        assert ok, numbers
        assert all(check[k]["value"] >= 0 for k in ONLINE), check
        assert numbers["lang_code_err"] is not None and numbers["map_step_err"] is not None


def _skipped(monkeypatch):
    """Every online step computes its loss and leaves the codec as it was."""
    from online_lang_splatting_tpu_torch.models import autoencoder
    from online_lang_splatting_tpu_torch.models.checkpoints import OnlineAETrainer

    def step(self, codes32):
        self.step_count += 1
        loss = autoencoder.online_loss(self.model(codes32), codes32).detach()
        self.loss_history.append(loss)
        return loss

    monkeypatch.setattr(OnlineAETrainer, "_step", step)


def _cos_weight(monkeypatch):
    """The online loss weighs its cosine term 0.5 for 0.6."""
    from online_lang_splatting_tpu_torch.models import autoencoder

    loss = autoencoder.online_loss
    monkeypatch.setattr(autoencoder, "online_loss",
                        lambda pred, target: loss(pred, target, cos_weight=0.5))


def _stale_code(monkeypatch):
    """An extraction encodes its codes with the weights from before its step."""
    from online_lang_splatting_tpu_torch.models.checkpoints import OnlineAETrainer

    def train_and_encode(self, codes32):
        with torch.no_grad():
            code = self.model.encode(codes32)
        self._step(codes32)
        return code

    monkeypatch.setattr(OnlineAETrainer, "train_and_encode", train_and_encode)


@pytest.mark.parametrize("fault, number", [(_skipped, "online_ae_step_err"),
                                           (_cos_weight, "online_ae_step_err"),
                                           (_stale_code, "online_code_err")],
                         ids=["step_skipped", "cos_weight", "stale_code"])
def test_planted_faults(sound, monkeypatch, fault, number):
    fault(monkeypatch)
    largest = max(numbers[number] for _, numbers, _ in sound)
    for seed in SEEDS:
        ok, numbers, _ = _two_stage(seed)
        assert not ok, numbers
        assert numbers[number] >= 10 * largest, (seed, numbers[number], largest)


def test_a_one_stage_run_keeps_its_check_keys():
    c = small.cell("slam_replicav2_lang15.orbit", frames=FRAMES + 2, trajectory_frames=30)
    ok, numbers, check = _run(c, SEEDS[0])
    assert ok, numbers
    assert numbers["online_ae_step_err"] is None and numbers["online_code_err"] is None
    assert list(check) == ["pose_rot_err_rad", "render_rel_err", "lang_code_err",
                           "map_grad_err", "map_step_err"]

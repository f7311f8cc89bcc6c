"""The check's control on the card, at a size a test run holds: the
program with TF32 on (the precision below the configurations' float32,
the program's own switch) comes out not correct, where the same run in
float32 is correct. The control at the cells' own sizes is run by
`perfbench/run.py --control tf32` (PERF.md gives its readings)."""

import time

import pytest
import torch

from perfbench.harness import common, slam_cell, stream_cell
from perfbench.tests import small

SEEDS = (2**31 + 21, 2**31 + 22, 2**31 + 23)


def _run(workload, system, seed, control, **kw):
    traffic = kw.pop("traffic", {})
    if workload == "two_stage":
        c = small.two_stage(clip=256, **traffic)
    else:
        c = small.cell(workload, **traffic)
        c["config"]["extractor"].update(clip_resolution=[256, 256])
    if system is slam_cell:
        c["config"]["slam"]["Training"]["use_gt_pose"] = True
    out = system.run(c, seed, 1e9, False, time.time(), device="cuda", control=control, **kw)
    ok, _ = common.judge(out["numbers"], c["limits"])
    return ok and out["failed"] == 0, out["numbers"]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_stream_control_fails(card, seed):
    ok, sound = _run("sed_convnext_l_768.stream", stream_cell, seed, None, max_frames=4,
                     traffic={"sample_every": 1})
    assert ok, sound
    ok, tf32 = _run("sed_convnext_l_768.stream", stream_cell, seed, "tf32", max_frames=4,
                    traffic={"sample_every": 1})
    assert not ok, tf32
    assert not torch.backends.cuda.matmul.allow_tf32  # put back for the reference


@pytest.mark.card
def test_slam_control_fails(card):
    kw = dict(should_stop=lambda idx: idx > 6, traffic={"frames": 9, "trajectory_frames": 30})
    ok, sound = _run("slam_replicav2_lang15.orbit", slam_cell, SEEDS[0], None, **dict(kw))
    assert ok, sound
    ok, tf32 = _run("slam_replicav2_lang15.orbit", slam_cell, SEEDS[0], "tf32", **dict(kw))
    assert not ok, tf32


@pytest.mark.card
def test_two_stage_slam_control_fails(card):
    """The orbit with the two-stage codec; its online numbers are read."""
    kw = dict(should_stop=lambda idx: idx > 6, traffic={"frames": 9, "trajectory_frames": 30})
    ok, sound = _run("two_stage", slam_cell, SEEDS[1], None, **dict(kw))
    assert ok, sound
    assert sound["online_ae_step_err"] is not None and sound["online_code_err"] is not None
    ok, tf32 = _run("two_stage", slam_cell, SEEDS[1], "tf32", **dict(kw))
    assert not ok, tf32

"""The window's stop: a run that the harness's `_camera` wrapper ends at
the request of frame k + 1 leaves the poses and keyframes of an
uninterrupted run of k + 1 frames; and a window whose length passes before
it has made a keyframe closes at once untraced, and traced holds its
first keyframe's mapping (configs/synthetic/smoke.yaml, CPU)."""

import time

import numpy as np
import pytest
import torch

from perfbench.harness.common import ROOT, StopWindow
from perfbench.harness.slam_cell import FrameClock, window_closes


def _slam():
    from online_lang_splatting_tpu_torch.slam.config import load_config
    from online_lang_splatting_tpu_torch.slam.system import SLAM

    cfg = load_config(ROOT / "configs" / "synthetic" / "smoke.yaml")
    cfg["raster_tile"] = 16
    return SLAM(cfg, device="cpu")


def test_a_stopped_run_equals_a_shorter_run():
    torch.set_num_threads(2)
    k = 5
    stopped = _slam()
    opened = []
    clock = FrameClock(stopped, lambda idx: idx > k, on_open=lambda: opened.append(True))
    try:
        stopped.run()
        raise AssertionError("the window did not stop")
    except StopWindow:
        pass
    assert opened == [True] and clock.first == 1 and clock.stopped_at == k + 1
    assert clock.t_close >= clock.t_open
    whole = _slam().run(max_frames=k + 1)
    a, b = stopped.frontend, whole.frontend
    assert a.kf_indices == b.kf_indices and len(a.kf_indices) >= 2
    assert sorted(a.cameras) == sorted(b.cameras) == list(range(k + 1))
    for i in range(k + 1):
        assert np.array_equal(a.cameras[i].r, b.cameras[i].r)
        assert np.array_equal(a.cameras[i].t, b.cameras[i].t)
    assert a.track_iters == b.track_iters


@pytest.mark.parametrize("hold_until, closes_at", [(None, 2), (1e9, 4)],
                         ids=["untraced", "traced"])
def test_a_traced_window_holds_a_keyframe(hold_until, closes_at):
    """smoke.yaml's keyframes are frames 0, 3, 5 and 7. A window whose
    length has passed at its second frame: the untraced rule closes it
    there with no keyframe; the traced rule (`hold_until`) closes it at the
    end of its first keyframe's mapping."""
    torch.set_num_threads(2)
    slam = _slam()
    fe = slam.frontend

    def should_stop(idx):
        made = [k for k in fe.kf_indices if k >= clock.first]
        return window_closes(idx, time.time() - clock.t_open, made, 0.0, hold_until)

    clock = FrameClock(slam, should_stop)
    with pytest.raises(StopWindow):
        slam.run()
    made = [k for k in fe.kf_indices if k >= clock.first]
    assert clock.first == 1 and clock.stopped_at == closes_at
    assert made == ([] if hold_until is None else [closes_at - 1])


def test_the_rule_closes_where_it_closed_without_a_hold():
    """With a keyframe made, or untraced, the hold changes nothing: past
    the length at the end of a keyframe's mapping or past 1.5 times it."""
    for hold in (None, 72.0):
        assert not window_closes(9, 47.9, [5], 48.0, hold)
        assert window_closes(6, 50.0, [5], 48.0, hold)
        assert not window_closes(7, 50.0, [5], 48.0, hold)
        assert window_closes(7, 72.0, [5], 48.0, hold)
    assert window_closes(7, 50.0, [], 48.0, None)
    assert not window_closes(7, 71.9, [], 48.0, 72.0)
    assert window_closes(7, 72.0, [], 48.0, 72.0)

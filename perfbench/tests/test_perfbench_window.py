"""The window's stop: a run that the harness's `_camera` wrapper ends at
the request of frame k + 1 leaves the poses and keyframes of an
uninterrupted run of k + 1 frames (configs/synthetic/smoke.yaml, CPU)."""

import numpy as np
import torch

from perfbench.harness.common import ROOT, StopWindow
from perfbench.harness.slam_cell import FrameClock


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

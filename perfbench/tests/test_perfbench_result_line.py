"""The result line's keys, the order of its compared numbers, and the
judgement of numbers against limits."""

import json
import math

from perfbench.harness import common


def test_result_line_has_the_contract_keys_and_check_last():
    line = common.result_line(correct=True, attempted=3, failed=0,
                              metrics={"slam_fps": {"value": 0.3, "unit": "frames/s"}},
                              device={"platform": "gpu", "kind": "x", "count": 1,
                                      "memory_peak_bytes": 5},
                              check={"pose_rot_err_rad": {"value": 1e-3, "limit": 1e-2}})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    traced = json.loads(common.result_line(
        correct=False, attempted=1, failed=1, metrics={}, device={}, check={},
        breakdown={"device_ops": [], "idle_gaps": []}))
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "check"]


def test_judge():
    limits = {"a": 1.0, "b": 2.0}
    assert common.judge({"a": 0.5, "b": 2.0}, limits)[0]
    assert not common.judge({"a": 1.5, "b": 1.0}, limits)[0]
    assert not common.judge({"a": math.nan, "b": 1.0}, limits)[0]
    ok, check = common.judge({"a": 0.5, "b": None}, limits)
    assert ok and list(check) == ["a"]
    assert not common.judge({"a": None}, limits)[0]  # nothing compared


def test_per_layer_readers_leave_out_what_they_cannot_read():
    metrics = [m for m in common.manifest()["per_layer"]]
    ctx = {"kind": "slam", "frames": 0, "phase_s": {}, "track_iters": 0, "map_iters": 0,
           "extract_s": 0.0, "extractions": 0}
    assert common.read_per_layer(metrics, ctx) == {}
    ctx = dict(ctx, frames=4, track_iters=200, phase_s={"data": 0.02, "track": 3.0, "map": 0.0})
    got = common.read_per_layer(metrics, ctx)
    assert set(got) == {"data_ms_per_frame", "track_ms_per_iter"}
    assert got["track_ms_per_iter"] == {"value": 15.0, "unit": "ms"}

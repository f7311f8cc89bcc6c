"""The port's instrumentation against the JAX package's: Timers (spans,
counts, the report's text), `trace` on the CPU (a torch.profiler trace
file written for TensorBoard / Perfetto), and the tagged `Log`."""

import json
import time

import jax.numpy as jnp
import pytest
import torch

from online_lang_splatting_tpu.slam import logging_utils as jlog
from online_lang_splatting_tpu.utils import profiling as jprof
from online_lang_splatting_tpu_torch.slam import logging_utils
from online_lang_splatting_tpu_torch.utils import profiling


def test_timers_count_and_report_like_jax():
    got, ref = profiling.Timers(), jprof.Timers()
    x = torch.ones(64, 64)
    for _ in range(3):
        with got.span("render", fence=x @ x):
            time.sleep(0.002)
        with ref.span("render", fence=jnp.ones((64, 64))):
            time.sleep(0.002)
    with got.span("map", fence={"a": x, "b": [x, "cpu"]}):
        pass
    with ref.span("map"):
        pass
    assert dict(got.counts) == dict(ref.counts) == {"render": 3, "map": 1}
    assert got.totals["render"] >= 0.006
    # The same totals give the same text.
    got.totals.update(ref.totals)
    assert got.report() == ref.report()
    assert got.report().splitlines()[1].startswith("render: total ")


def test_trace_writes_a_profiler_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "tb")):
        y = torch.randn(128, 128) @ torch.randn(128, 128)
        y.sum().item()
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("tag", ["MonoGS", "Backend", "Eval", "Frontend", "GUI", "other"])
def test_log_matches_jax(tag, capsys):
    logging_utils.Log("keyframe", 3, tag=tag)
    got = capsys.readouterr().out
    jlog.Log("keyframe", 3, tag=tag)
    assert got == capsys.readouterr().out
    assert f"[{tag}]" in got

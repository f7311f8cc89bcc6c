"""The readers of the program's own spans (harness/program_spans.py; the
metrics syncs_per_track_iter, track_sync_wait_ms_per_iter,
track_enqueue_ms_per_iter, syncs_per_frame.slam and
extract_enqueue_ms_per_frame): finite numbers from the small orbit and
stream runs recorded under a profiler session, nothing outside the window;
and on the card, a program span against the profiler's launch record of
the launch it holds (the two clocks agree), and each tracking iteration's
sync spans against the syncs torch's sync debug mode reports in it."""

import math
import threading
import time
import warnings

import pytest
import torch

from perfbench.harness import common, program_spans, slam_cell, stream_cell
from perfbench.harness.tracer import Profile, Trace
from perfbench.tests import small

SEED = 2**31 + 41
NEW = {"slam_replicav2_lang15.orbit": ["syncs_per_track_iter", "track_sync_wait_ms_per_iter",
                                       "track_enqueue_ms_per_iter", "syncs_per_frame.slam"],
       "sed_convnext_l_768.stream": ["extract_enqueue_ms_per_frame"]}


def _recorded(run):
    """run()'s context, with the window of a CPU profiler session around
    it as its `trace`."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    t0 = time.time_ns()
    try:
        out = run()
    finally:
        t1 = time.time_ns()
        prof.stop()
    ctx = out["ctx"]
    ctx["trace"] = Trace(t0, t1, [], [])
    return ctx


def _orbit(device, frames=5, **kw):
    torch.set_num_threads(2)
    c = small.cell("slam_replicav2_lang15.orbit", frames=frames + 2, trajectory_frames=30)
    return c, lambda: slam_cell.run(c, SEED, 1e9, False, time.time(), device=device,
                                    should_stop=lambda idx: idx > frames, **kw)


@pytest.fixture(scope="module")
def contexts():
    _, orbit = _orbit("cpu")
    c = small.cell("sed_convnext_l_768.stream", sample_every=2)
    stream = lambda: stream_cell.run(c, SEED, 1e9, False, time.time(), device="cpu",  # noqa: E731
                                     max_frames=4)
    return {"slam_replicav2_lang15.orbit": _recorded(orbit),
            "sed_convnext_l_768.stream": _recorded(stream)}


@pytest.mark.parametrize("workload", sorted(NEW))
def test_new_readers_read_the_program_spans(contexts, workload):
    ctx = contexts[workload]
    metrics = [m for m in common.cell(common.manifest(), workload)["per_layer"]
               if m["name"] in NEW[workload]]
    assert [m["name"] for m in metrics] == NEW[workload]
    got = common.read_per_layer(metrics, ctx)
    assert sorted(got) == sorted(NEW[workload]), got
    assert all(math.isfinite(v["value"]) and v["value"] >= 0 for v in got.values()), got
    if workload.startswith("slam"):
        # The binning's three syncs and the convergence read, at least.
        assert got["syncs_per_track_iter"]["value"] >= 4
        assert got["syncs_per_frame.slam"]["value"] > got["syncs_per_track_iter"]["value"]
        assert got["track_enqueue_ms_per_iter"]["value"] > 0
    else:
        assert got["extract_enqueue_ms_per_frame"]["value"] > 0
    # A window that closed before the run holds none of the program's spans.
    early = dict(ctx, trace=Trace(ctx["trace"].t0 - 10**9, ctx["trace"].t0, [], []))
    assert common.read_per_layer(metrics, early) == {}


def test_window_nests_sync_spans_below_their_ancestors(contexts):
    win = program_spans.window(contexts["slam_replicav2_lang15.orbit"])
    its = win.named("track.iter")
    assert its and all(s.frame is not None for s in its)
    for it in its:
        below = win.syncs_below(it)
        assert all(it.t0_ns <= y.t0_ns <= y.t1_ns <= it.t1_ns for y in below)
    assert len(win.syncs()) > sum(len(win.syncs_below(s)) for s in its)


@pytest.mark.card
def test_a_program_span_holds_the_launch_record_of_its_launch(card):
    from online_lang_splatting_tpu_torch.utils import profiling

    a = torch.ones(1 << 20, device=card)
    b = torch.empty_like(a)
    torch.cuda.synchronize()
    prof = Profile()
    prof.start()
    torch.add(a, 1.0, out=b)
    time.sleep(0.005)
    with profiling.span("probe"):
        torch.mul(a, 2.0, out=b)
    time.sleep(0.005)
    torch.add(a, 3.0, out=b)
    prof.stop(torch.cuda.synchronize)
    trace = prof.reduce()
    win = program_spans.window({"trace": trace})
    (probe,) = win.named("probe")
    inside = [t for t in trace.launches if probe.t0_ns <= t <= probe.t1_ns]
    assert len(trace.launches) == 3 and len(inside) == 1, (trace.launches, probe)


@pytest.mark.card
def test_tracking_sync_spans_match_the_sync_debug_mode(card):
    """Each tracking iteration of a small orbit run on the card: its sync
    spans, and the synchronizing calls torch reports inside it."""
    reported = []

    def hook(message, *args, **kwargs):
        if "synchroniz" in str(message):
            reported.append((time.time_ns(), threading.get_ident()))

    _, run = _orbit("cuda", frames=3)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ctx = _recorded(run)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    win = program_spans.window(ctx)
    its = win.named("track.iter")
    assert len(its) >= 3
    for it in its:  # the prefetch thread's uploads run beside the loop
        n = sum(it.t0_ns <= t <= it.t1_ns and th == it.thread for t, th in reported)
        assert n == len(win.syncs_below(it)) >= 4, (n, [s.name for s in win.syncs_below(it)])

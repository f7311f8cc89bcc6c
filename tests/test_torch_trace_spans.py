"""The port's own spans (`utils/profiling.span`, `RECORDER`): nothing is
recorded without a `torch.profiler` session; under one, named and nested
spans on `time.time_ns()` inside the session, shown in the profiler's
trace too; a tracking run's iteration spans and the sync spans of each
iteration; the same tracking results with the recorder on and off; the
extractor's frame span with its tower, HR head and AE children; and the
SLAM loop's frame, keyframe and phase-fence spans."""

import json
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_helpers import map_from_frame, t

from online_lang_splatting_tpu_torch.convert import gaussians_from_numpy
from online_lang_splatting_tpu_torch.models.sed import LangFeatureExtractor
from online_lang_splatting_tpu_torch.ops.raster import RasterSettings
from online_lang_splatting_tpu_torch.slam import datasets, frontend, renderer
from online_lang_splatting_tpu_torch.slam.config import load_config
from online_lang_splatting_tpu_torch.slam.system import SLAM
from online_lang_splatting_tpu_torch.utils import profiling

SMOKE = "configs/synthetic/smoke.yaml"
# The sync spans of one tracking iteration: the render's pose perturbation
# and the step's retraction (each an upload of se3_exp's constant row), the
# binning's instance count and its two compactions, the convergence read.
TRACK_ITER_SYNCS = {"sync.lie.row": 2, "sync.binning.count": 1, "sync.binning.keep": 2,
                    "sync.track.converge": 1}


def _recorded(fn):
    """fn()'s result, the spans it recorded under a CPU profiler session,
    the session's start and stop on time.time_ns(), and the profiler."""
    profiling.RECORDER.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    t0 = time.time_ns()
    try:
        out = fn()
    finally:
        t1 = time.time_ns()
        prof.stop()
    return out, profiling.RECORDER.spans(), t0, t1, prof


def test_nothing_is_recorded_without_a_profiler_session():
    profiling.RECORDER.clear()
    assert not torch.autograd.profiler._is_profiler_enabled
    # The no-op is shared: a span off allocates nothing.
    assert profiling.span("a") is profiling.span("sync.b")
    with profiling.span("a"):
        with profiling.span("sync.b"):
            torch.ones(3).sum().item()
    assert profiling.RECORDER.spans() == [] and profiling.RECORDER.dropped == 0


def test_named_nested_spans_inside_the_session():
    """Recorded under any session; shown in the trace only inside `trace`."""

    def body():
        profiling.set_frame(7)
        with profiling.span("outer"):
            with profiling.span("sync.inner"):
                time.sleep(0.001)
            with profiling.span("second"):
                pass
        profiling.set_frame(None)

    _, spans, t0, t1, prof = _recorded(body)
    by_name = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["sync.inner", "second", "outer"]  # the order they closed
    outer = by_name["outer"]
    assert outer.parent is None
    assert by_name["sync.inner"].parent == by_name["second"].parent == outer.id
    for s in spans:
        assert t0 <= outer.t0_ns <= s.t0_ns <= s.t1_ns <= outer.t1_ns <= t1
        assert s.frame == 7 and s.thread == spans[0].thread
    assert by_name["sync.inner"].t1_ns - by_name["sync.inner"].t0_ns >= 1_000_000
    assert not {"outer", "sync.inner", "second"} & {e.key for e in prof.key_averages()}


def test_trace_shows_the_spans_beside_the_operators(tmp_path):
    profiling.RECORDER.clear()
    with profiling.trace(str(tmp_path / "tb")):
        with profiling.span("outer"):
            with profiling.span("sync.inner"):
                torch.ones(3).sum().item()
    assert not profiling.RECORDER.annotate
    assert [s.name for s in profiling.RECORDER.spans()] == ["sync.inner", "outer"]
    (path,) = (tmp_path / "tb").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"outer", "sync.inner", "aten::sum"} <= names


def test_the_cap_counts_what_it_drops():
    cap = profiling.RECORDER.cap
    profiling.RECORDER.cap = 2

    def five():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass

    try:
        _, spans, *_ = _recorded(five)
    finally:
        profiling.RECORDER.cap = cap
    assert [s.name for s in spans] == ["s0", "s1"] and profiling.RECORDER.dropped == 3


def test_threads_record_every_span_and_their_own_nesting():
    """More threads than cores, a short switch interval: no span is lost,
    ids are unique, and each span's parent is its own thread's."""
    n_threads, n_spans = 16, 200

    def work(k):
        profiling.set_frame(k)
        for _ in range(n_spans):
            with profiling.span("outer"):
                with profiling.span("sync.inner"):
                    pass

    def body():
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(interval)

    _, spans, *_ = _recorded(body)
    assert len(spans) == 2 * n_threads * n_spans
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.name == "sync.inner":
            p = by_id[s.parent]
            assert p.name == "outer" and (p.thread, p.frame) == (s.thread, s.frame)
        else:
            assert s.parent is None
    assert len({s.frame for s in spans}) == n_threads


@pytest.fixture(scope="module")
def tracking():
    """A small tracking run's arguments: the smoke scene's frame 1 from
    frame 0's pose, on a map back-projected from frame 0."""
    cfg = load_config(SMOKE)
    ds = datasets.SyntheticDataset(cfg)
    tp, ta, _ = gaussians_from_numpy(map_from_frame(ds))
    color, depth, _, _, _ = ds[1]
    _, _, w2c0, _, _ = ds[0]
    from online_lang_splatting_tpu_torch.ops import graphics

    proj = graphics.projection_matrix(0.01, 100.0, ds.cx, ds.cy, ds.fx, ds.fy, ds.width,
                                      ds.height)
    settings = RasterSettings(image_height=ds.height, image_width=ds.width,
                              tanfovx=np.tan(ds.fovx / 2), tanfovy=np.tan(ds.fovy / 2),
                              sh_degree=0, backend="cuda", tile=16)
    tr = cfg["Training"]

    def run():
        return frontend.tracking_run(
            renderer.activate(tp, ta.active), t(w2c0), proj.float(), t(color),
            t(depth)[None], torch.ones((1, ds.height, ds.width), dtype=torch.bool), 0.0, 0.0,
            (tr["lr"]["cam_trans_delta"], tr["lr"]["cam_rot_delta"], 0.01),
            settings=settings, max_iters=6, rgb_threshold=tr["rgb_boundary_threshold"])

    return run


def test_tracking_records_its_iterations_and_their_syncs(tracking):
    out, spans, *_ = _recorded(tracking)
    its = [s for s in spans if s.name == "track.iter"]
    assert out[3] == len(its) == 6
    for it in its:
        below = Counter(s.name for s in spans if s.parent == it.id)
        assert below == TRACK_ITER_SYNCS, below
    # The tail's final render: its binning's syncs, then the median's mask.
    tail = Counter(s.name for s in spans if s.parent is None and s.t0_ns > its[-1].t1_ns)
    assert tail == {"sync.binning.count": 1, "sync.binning.keep": 2,
                    "sync.track.median": 1}, tail


def test_tracking_is_the_same_with_the_recorder_on_and_off(tracking):
    torch.set_num_threads(2)
    off = tracking()
    on, spans, *_ = _recorded(tracking)
    assert spans
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_encode_frame_records_its_stages():
    ex = LangFeatureExtractor(encoder_dims=(16, 8, 15), decoder_dims=(8, 16, 32),
                              clip_resolution=(64, 64), depths=(1, 1, 1, 1),
                              dims=(8, 16, 32, 64), embed_dim=32, clip_dim=32, device="cpu")
    frame = torch.rand((48, 64, 3), generator=torch.Generator().manual_seed(0)) * 255.0
    code, spans, *_ = _recorded(lambda: ex.encode_frame(frame))
    assert code.shape == (16, 16, 15)
    (top,) = [s for s in spans if s.name == "extract.frame"]
    kids = [s.name for s in spans if s.parent == top.id]
    assert kids == ["extract.tower", "extract.hr", "extract.ae"]
    # Its syncs: the normalization's two constants, and the HR head's three
    # upsamples' kernel taps (two list indices for each of four phases).
    below = {k: Counter(s.name for s in spans if s.parent == k.id) for k in spans
             if k.parent == top.id}
    syncs = {k.name: {n: c for n, c in v.items() if n.startswith(profiling.SYNC)}
             for k, v in below.items()}
    assert syncs == {"extract.tower": {"sync.extract.normalize": 2}, "extract.ae": {},
                     "extract.hr": {"sync.extract.upsample": 24}}, syncs
    assert torch.equal(code, ex.encode_frame(frame))


def test_slam_loop_spans_name_frames_keyframes_and_phase_fences():
    cfg = load_config(SMOKE)
    cfg["raster_tile"] = 16
    slam = SLAM(cfg, device="cpu")
    _, spans, *_ = _recorded(lambda: slam.run(max_frames=6))
    frames = [s for s in spans if s.name == "slam.frame"]
    assert [s.frame for s in frames] == list(range(6))
    kf = slam.frontend.kf_indices
    inserts = [s.frame for s in spans if s.name == "slam.kf_insert"]
    assert inserts == kf[1:] and len(inserts) >= 1
    assert [s.frame for s in spans if s.name == "slam.kf_decide"] == list(range(1, 6))
    fences = Counter(s.name for s in spans if s.name.startswith("sync.phase."))
    assert fences == {"sync.phase.data": 6, "sync.phase.init": 1, "sync.phase.track": 5,
                      "sync.phase.kf_insert": len(inserts), "sync.phase.map": len(inserts)}
    iters = [s for s in spans if s.name == "track.iter"]
    assert len(iters) == sum(slam.frontend.track_iters)
    maps = [s for s in spans if s.name == "map.iter"]
    assert len(maps) == slam.backend.iteration_count
    # Every span of a frame carries its index; each child closes inside its parent.
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.frame is not None
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns and p.frame == s.frame

"""Extractor cells: `LangFeatureExtractor.encode_frame` on distinct frames
fed one at a time, a synchronize after each (as the SLAM's keyframe
supervision and the label tools call it), closed loop, until the window's
length is spent. The pool of frames is the benchmark's scene seen from
poses spread over its trajectory, made on the device. Each call's latency
runs from a CUDA event recorded as the call starts to one recorded after
its last kernel, on the card's clock."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench.harness import counts, scene, weights
from perfbench.harness.common import rel_fro
from perfbench.reference import extractor as ref_extractor


def frames(traffic: dict, calib: dict, device) -> list:
    """`pool` distinct (H, W, 3) float32 RGB frames in [0, 255]."""
    tex = torch.as_tensor(scene.texture(), device=device)
    n, traj = traffic["pool"], traffic["trajectory_frames"]
    step = max(traj // n, 1)
    return [scene.render_frame(scene.pose(i * step, traj), tex, calib)[0] * 255.0
            for i in range(n)]


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        control: str | None = None, max_frames: int | None = None) -> dict:
    from online_lang_splatting_tpu_torch import entry_device

    cfg, traffic = cell["config"], cell["traffic"]
    device = entry_device(device)
    on_card = device.type == "cuda"
    pool = frames(traffic, cfg["calibration"], device)
    extractor = weights.extractor(cfg["extractor"], seed, device,
                                  use_hr=cfg["extractor"]["hr_model"])
    if control == "tf32":  # the program's own lower precision, after its pinning
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    for frame in pool[:traffic["warmup"]]:
        extractor.encode_frame(frame)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    # Outputs kept for the check: every `sample_every`-th call from an
    # offset drawn from the seed.
    rng = np.random.default_rng(seed)
    every = traffic["sample_every"]
    offset = int(rng.integers(every))
    kept, events = {}, []
    prof = spans = None
    if trace:
        from perfbench.harness.tracer import Profile, Spans

        prof, spans = Profile(), Spans()
        spans.wrap(extractor, "encode_frame", "encode")
        prof.start()
    t_open = time.time()
    i = 0
    while True:
        frame = pool[i % len(pool)]
        if on_card:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        code = extractor.encode_frame(frame)
        if on_card:
            b.record()
            events.append((a, b))
        sync()
        if i % every == offset:
            kept[i] = code
        i += 1
        if time.time() - t_open >= seconds or (max_frames is not None and i >= max_frames):
            break
    t_close = time.time()
    if trace:
        prof.stop(sync)
    kept[i - 1] = code
    window_s = t_close - t_open
    lat = [a.elapsed_time(b) for a, b in events]
    e2e = {"lang_maps_per_s": i / window_s, "setup_s": t_open - t_start}
    if lat:
        e2e["lang_map_p95_ms"] = float(np.percentile(lat, 95))
    # The device's peak memory, read before the reference runs.
    out = dict(frames=i, window_s=window_s, e2e=e2e, attempted=i,
               peak=torch.cuda.max_memory_allocated() if on_card else 0)
    ctx = dict(kind="extract", frames=i, window_s=window_s,
               extract_flops=counts.extractor_flops(cfg["extractor"]))
    if trace:
        ctx.update(trace=prof.reduce(), spans=spans)
    out["ctx"] = ctx
    del extractor
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["numbers"], out["failed"] = check(cfg, traffic, seed, device, pool, kept, rng)
    out["detail"] = {"latency_ms_median": float(np.median(lat)) if lat else None}
    return out


def check(cfg, traffic, seed, device, pool, kept: dict, rng) -> tuple[dict, int]:
    """The compared number: each sampled call's codes against the plain
    extractor on the same frame and weights (Frobenius error over the
    reference's norm), the worst of at most `check_samples` calls drawn
    from the seed, the window's last call among them."""
    ids = sorted(kept)
    if len(ids) > traffic["check_samples"]:
        pick = rng.choice(len(ids) - 1, traffic["check_samples"] - 1, replace=False)
        ids = sorted({ids[j] for j in pick} | {ids[-1]})
    w = weights.draw(cfg["extractor"], seed, device)
    worst, failed = 0.0, 0
    for i in ids:
        got = kept[i]
        if not bool(torch.isfinite(got).all()):
            failed += 1
        want = ref_extractor.encode_frame(pool[i % len(pool)], w, cfg["extractor"])
        worst = max(worst, rel_fro(got, want))
    return {"code_err": worst if ids else None}, failed

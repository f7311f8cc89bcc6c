#!/usr/bin/env python
"""GPU smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py [--frames 8] [--config configs/synthetic/replica_scale.yaml]

Phases (each prints its own lines; any failure raises, so the exit code is
non-zero):
  0. require CUDA; print the card's name and power limit (nvidia-smi);
  1. build the blend kernels from csrc/ and print the build time;
  2. kernel vs plain PyTorch version on the card, on the ten golden scenes
     (tests/goldens, tests/goldens_t32) at F_lang 15 and 0, stats on and
     off; the kernel path is also held against the golden npz;
  3. the main path as a user runs it (slam_torch.main): single-thread SLAM
     on the replica-scale synthetic scene at its full 1200x680, capacity
     131072, tile 32, 15 language channels supervised by the ConvNeXt-L
     CLIP extractor + HR head + one-stage autoencoder (seeded random
     weights), with quality bounds and kernel launch counts;
  4. kernel and plain times at the main path's shapes (final map, last
     frame's pose), CUDA events, medians;
  5. the extractor at full width: frame 0 (1200x680) -> 768^2 -> ConvNeXt-L
     -> HR head -> AE -> (192, 192, 15), unit-norm codes; the card against
     the port's own CPU path at 128^2 on the same weights; median times of
     the fused frame, the tower and the HR head, and the peak memory;
  6. open-vocabulary mIoU: the synthetic-scene harness (16 frames, 192^2
     supervision, 9 classes) through the blend kernels, once with the
     two-stage online codec and once with the one-stage codec, held to the
     replica-scale gates (the 0.7 mIoU lock on the one-stage run);
then one JSON line of the language numbers, one of per-kernel results and,
last, the ok line.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FWD_TOL, GRAD_TOL = 1e-4, 2e-3  # normalized; the goldens' tolerances
# Quality bounds of the 40-frame replica-scale gate
# (tools/replica_scale_gate.py): bounds on quality, not on speed.
GATE_TRANS_ERR, GATE_PSNR = 0.012, 11.0
# Real language supervision (tests/test_lang_integration.py): the rendered
# map's L1 to a keyframe's supervision below this share of the
# supervision's own mean |value|, and the supervision not all zeros.
LANG_L1_RATIO, LANG_NONZERO = 0.8, 1e-3
EXTRACTOR_TOL, UNIT_NORM_TOL = 1e-4, 1e-5  # card vs CPU (normalized); |code| - 1
# Replica-scale mIoU gates (tools/synthetic_miou_gate.py). The 0.7 mIoU
# lock holds the one-stage codec. The two-stage run is held to the JAX
# package's two-stage lock: its online codec trains 209 init steps on
# keyframe 0's codes alone and encodes each keyframe's target once, so
# classes first seen later decode poorly, in both packages alike (PERF.md).
GATE_MIOU_STAGE = {1: 0.7, 2: 0.35}
GATE_LOC, GATE_QUERIES, GATE_FRAMES, GATE_AE_COS = 0.75, 8, 8, 0.98
MIOU_FRAMES = 16


def phase0_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[phase0] card: {smi}")
    print(f"[phase0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return smi


def phase1_build():
    from online_lang_splatting_tpu_torch.ops.raster import kernels

    t0 = time.time()
    kernels.library()
    info = kernels.build_info
    print(f"[phase1] kernels {'built' if info['built'] else 'cached'} in "
          f"{time.time() - t0:.2f} s -> {info['path']}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[phase1] ptxas: {line.strip()}")


def _norm_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1.0))


def _compare_blend(geom, feat, binning, g_feat, g_t, *, width, height, tile,
                   stats):
    """Kernel wrapper vs plain version on the same CUDA tensors."""
    from online_lang_splatting_tpu_torch.ops.raster import tiled

    args = (geom, feat, binning.s_gid, binning.starts, binning.tile_counts)
    kw = dict(width=width, height=height, tile=tile)
    k = tiled.blend_forward(*args, stats=stats, **kw)
    p = tiled.blend_forward_plain(*args, stats=stats, **kw)
    torch.cuda.synchronize()
    errs = {"feat_img": _norm_err(k[0], p[0]), "final_t": _norm_err(k[1], p[1]),
            "n_contrib": int((k[2] != p[2]).sum()),
            "n_touched": int((k[3] != p[3]).sum())}
    kb = tiled.blend_backward(*args, g_feat, g_t, p[0], p[1], **kw)
    pb = tiled.blend_backward_plain(*args, g_feat, g_t, p[0], p[1], **kw)
    torch.cuda.synchronize()
    errs["d_geom"] = _norm_err(kb[0], pb[0])
    errs["d_feat"] = _norm_err(kb[1], pb[1])
    abs_err = max(_abs_err(k[0], p[0]), _abs_err(k[1], p[1]))
    abs_err_b = max(_abs_err(kb[0], pb[0]), _abs_err(kb[1], pb[1]))
    return errs, abs_err, abs_err_b


def _abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def _check(errs: dict, where: str):
    for key, v in errs.items():
        if key in ("n_contrib", "n_touched", "radii"):
            ok = v == 0
        elif key.startswith("d_"):
            ok = v <= GRAD_TOL
        else:
            ok = v <= FWD_TOL
        if not ok:
            raise AssertionError(f"{where}: {key} error {v} out of tolerance")


def phase2_goldens(dev):
    from online_lang_splatting_tpu_torch.ops.raster import api, scenes, tiled

    worst: dict = {}
    n_cases = 0
    for tile in (16, 32):
        for name in sorted(scenes.SCENES):
            scene = scenes.SCENES[name]()
            golden = scenes.load_golden(REPO, name, tile)
            for f_lang in (15, 0):
                for stats in (True, False):
                    # (a) kernel wrapper vs plain version on the card
                    t = {k: torch.as_tensor(v, device=dev) for k, v in scene.items()
                         if isinstance(v, np.ndarray)}
                    settings = api.RasterSettings(
                        image_height=scene["height"], image_width=scene["width"],
                        tanfovx=scene["tanfovx"], tanfovy=scene["tanfovy"],
                        sh_degree=0, tile=tile)
                    prep = api.project(
                        t["means3d"], t["opacities"], t["scales"], t["quats"],
                        viewmatrix=t["viewmatrix"], projmatrix=t["projmatrix"],
                        settings=settings, shs=t["shs"])
                    geom, feat, binning = tiled.blend_inputs(
                        prep, t["language_features"][:, :f_lang],
                        width=scene["width"], height=scene["height"], tile=tile)
                    h, w = scene["height"], scene["width"]
                    gen = torch.Generator(device=dev).manual_seed(n_cases)
                    g_feat = torch.randn((feat.shape[1], h, w), generator=gen, device=dev)
                    g_t = torch.randn((h, w), generator=gen, device=dev)
                    errs, _, _ = _compare_blend(geom, feat, binning, g_feat, g_t,
                                                width=w, height=h, tile=tile,
                                                stats=stats)
                    # (b) the kernel path end to end vs the golden npz
                    got = scenes.render_scene(scene, "cuda", tile=tile, device=dev,
                                              lang=f_lang > 0, stats=stats)
                    ref = dict(golden)
                    if not stats:
                        ref.pop("n_touched")
                        ref.pop("n_contrib")
                    if f_lang == 0:  # the golden loss also weights language
                        ref = {k: v for k, v in ref.items()
                               if k in ("color", "depth", "opacity", "final_t", "radii")
                               or (stats and k in ("n_touched", "n_contrib"))}
                    gerrs = scenes.max_normalized_error(got, ref)
                    where = f"tile{tile}/{name}/F{f_lang}/stats={stats}"
                    _check(errs, f"{where} kernel-vs-plain")
                    _check(gerrs, f"{where} kernel-vs-golden")
                    for k, v in list(errs.items()) + [(f"golden_{k}", v) for k, v in gerrs.items()]:
                        worst[k] = max(worst.get(k, 0), v)
                    print(f"[phase2] {where}: plain " + " ".join(
                        f"{k}={v:.2e}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in errs.items())
                        + " | golden max " + f"{max([v for k, v in gerrs.items() if isinstance(v, float)]):.2e}"
                        + " ints " + str(sum(v for v in gerrs.values() if isinstance(v, int))))
                    n_cases += 1
    print(f"[phase2] {n_cases} cases ok; worst: " + json.dumps(worst))


def _launch_counts(tiled) -> dict:
    return {"fwd_launches": tiled.FWD_STATS.launches,
            "bwd_launches": tiled.BWD_STATS.launches,
            "fwd_plain": tiled.FWD_STATS.plain_calls,
            "bwd_plain": tiled.BWD_STATS.plain_calls}


def _check_launches(counts: dict, where: str):
    if counts["fwd_launches"] == 0 or counts["bwd_launches"] == 0:
        raise AssertionError(f"{where}: a blend kernel was never launched: {counts}")
    if counts["fwd_plain"] or counts["bwd_plain"]:
        raise AssertionError(f"{where}: a plain blend ran: {counts}")


def phase3_main_path(config_path: str, frames: int, dev):
    import slam_torch
    from online_lang_splatting_tpu_torch.ops import losses
    from online_lang_splatting_tpu_torch.ops.raster import tiled
    from online_lang_splatting_tpu_torch.slam.backend import resize_bilinear
    from online_lang_splatting_tpu_torch.slam.renderer import activate, render

    tiled.FWD_STATS.reset()
    tiled.BWD_STATS.reset()
    t0 = time.time()
    slam = slam_torch.main(["--config", config_path, "--max-frames", str(frames),
                            "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _launch_counts(tiled)
    s = slam.settings
    fe, be = slam.frontend, slam.backend
    print(f"[phase3] config {config_path}: {s.image_width}x{s.image_height}, "
          f"capacity {be.cap}, tile {s.tile}, {be.lang_dim} language channels "
          f"supervised by {type(be.lang_extractor).__name__} "
          f"(hr head {be.lang_extractor.hr is not None}), {frames} frames")
    print(f"[phase3] wall {wall:.2f} s (extractor and SLAM construction included), "
          f"FPS {slam.fps:.4f}; phase times "
          + json.dumps({k: round(v, 3) for k, v in slam.phase_times.items()})
          + f"; language extraction {be.lang_extract_s:.3f} s of the init and map phases")
    print(f"[phase3] keyframes {fe.kf_indices}, gaussians "
          f"{int(be.aux.active.sum())} of capacity {be.cap}, tracking iters "
          f"{fe.track_iters}")
    print(f"[phase3] launches {json.dumps(counts)}")

    errs = []
    for idx, cam in sorted(fe.cameras.items()):
        if not (np.isfinite(cam.r).all() and np.isfinite(cam.t).all()):
            raise AssertionError(f"non-finite pose at frame {idx}")
        c_est = -cam.r.T @ cam.t
        c_gt = -cam.r_gt.T @ cam.t_gt
        errs.append(float(np.linalg.norm(c_est - c_gt)))
    max_err = max(errs[1:])

    inputs = activate(be.params, be.aux.active)
    lang = {}
    with torch.no_grad():
        for kf in fe.kf_indices:
            kcam = be.viewpoints[kf]
            out = render(inputs, torch.as_tensor(kcam.world_view_transform, device=dev),
                         slam.proj, s)
            sup = resize_bilinear(be.frame_stack.langs[kf], (s.image_height, s.image_width))
            lang[kf] = (float(torch.abs(out.language - sup).mean()),
                        float(sup.abs().mean()), float(sup.abs().max()))
        last = frames - 1
        lcam = fe.cameras[last]
        color, *_ = slam.dataset[last]
        view = torch.as_tensor(lcam.world_view_transform, device=dev)
        out = render(inputs, view, slam.proj, s)
        psnr = float(losses.psnr(torch.clamp(out.color, 0.0, 1.0),
                                 torch.as_tensor(color, device=dev)))
        num_instances = out.num_instances
    first = fe.kf_indices[0]
    l1, sup_mean, sup_max = lang[first]
    print(f"[phase3] max translation error {max_err:.5f} m (bound {GATE_TRANS_ERR}); "
          f"frame {last} PSNR {psnr:.3f} dB (bound {GATE_PSNR}); "
          f"instances at frame {last}: {num_instances}")
    print("[phase3] language L1 / supervision mean |value| per keyframe: " + ", ".join(
        f"{k}: {a:.5f}/{b:.5f}={a / b:.3f}" for k, (a, b, _) in lang.items())
        + f"; keyframe {first} bound {LANG_L1_RATIO}, supervision max {sup_max:.4f}")
    _check_launches(counts, "phase3")
    if not max_err < GATE_TRANS_ERR:
        raise AssertionError(f"translation error {max_err} >= {GATE_TRANS_ERR}")
    if not sup_max > LANG_NONZERO:
        raise AssertionError(f"keyframe {first} supervision is all zeros (max {sup_max})")
    if not l1 < LANG_L1_RATIO * sup_mean:
        raise AssertionError(f"language L1 {l1} >= {LANG_L1_RATIO} x {sup_mean}")
    if not psnr > GATE_PSNR:
        raise AssertionError(f"PSNR {psnr} <= {GATE_PSNR}")
    summary = dict(wall_s=wall, fps=slam.fps, phase_times=slam.phase_times,
                   extract_s=be.lang_extract_s, keyframes=len(fe.kf_indices),
                   lang_l1=l1, lang_sup_mean=sup_mean, psnr=psnr, max_trans_err=max_err,
                   launches=counts)
    return slam, counts, summary


def _time(fn, runs: int) -> float:
    """Median milliseconds of `runs` calls, CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase4_times(slam, dev):
    from online_lang_splatting_tpu_torch.ops.raster import api, tiled
    from online_lang_splatting_tpu_torch.slam.renderer import activate

    s = slam.settings
    fe, be = slam.frontend, slam.backend
    last = max(fe.cameras)
    view = torch.as_tensor(fe.cameras[last].world_view_transform, device=dev)
    inputs = activate(be.params, be.aux.active)
    w, h, tile = s.image_width, s.image_height, s.tile
    results = {}
    with torch.no_grad():
        prep = api.project(inputs.xyz, inputs.opacity, inputs.scales,
                           inputs.quats, viewmatrix=view, projmatrix=slam.proj,
                           settings=s, shs=inputs.shs)
        for f_lang in (15, 0):
            geom, feat, binning = tiled.blend_inputs(
                prep, inputs.language[:, :f_lang], width=w, height=h, tile=tile)
            gen = torch.Generator(device=dev).manual_seed(f_lang)
            g_feat = torch.randn((feat.shape[1], h, w), generator=gen, device=dev)
            g_t = torch.randn((h, w), generator=gen, device=dev)
            errs, abs_f, abs_b = _compare_blend(geom, feat, binning, g_feat, g_t,
                                                width=w, height=h, tile=tile,
                                                stats=True)
            _check(errs, f"main-path shapes F{f_lang}")
            args = (geom, feat, binning.s_gid, binning.starts, binning.tile_counts)
            kw = dict(width=w, height=h, tile=tile)
            fo = tiled.blend_forward(*args, **kw)

            def k_fwd():
                tiled.blend_forward(*args, stats=f_lang > 0, **kw)

            def k_fb():
                o = tiled.blend_forward(*args, stats=f_lang > 0, **kw)
                tiled.blend_backward(*args, g_feat, g_t, o[0], o[1], **kw)

            def k_bwd():
                tiled.blend_backward(*args, g_feat, g_t, fo[0], fo[1], **kw)

            def p_fwd():
                tiled.blend_forward_plain(*args, stats=f_lang > 0, **kw)

            def p_fb():
                o = tiled.blend_forward_plain(*args, stats=f_lang > 0, **kw)
                tiled.blend_backward_plain(*args, g_feat, g_t, o[0], o[1], **kw)

            def p_bwd():
                tiled.blend_backward_plain(*args, g_feat, g_t, fo[0], fo[1], **kw)

            # Turns: plain, kernel, kernel, plain (one card, one call).
            pf1, kf1 = _time(p_fwd, 3), _time(k_fwd, 20)
            kf2, pf2 = _time(k_fwd, 20), _time(p_fwd, 3)
            kfb, pfb = _time(k_fb, 10), _time(p_fb, 3)
            kb, pb = _time(k_bwd, 10), _time(p_bwd, 3)
            r = dict(instances=int(binning.s_gid.numel()),
                     demand=binning.num_instances,
                     fwd_ms=(kf1 + kf2) / 2, fwd_plain_ms=(pf1 + pf2) / 2,
                     fwd_bwd_ms=kfb, fwd_bwd_plain_ms=pfb,
                     bwd_ms=kb, bwd_plain_ms=pb, fwd_abs_err=abs_f,
                     bwd_abs_err=abs_b, errs=errs)
            results[f_lang] = r
            print(f"[phase4] F_lang {f_lang} ({w}x{h}, tile {tile}, "
                  f"{r['instances']} instances, {int(be.aux.active.sum())} gaussians): "
                  f"fwd kernel {r['fwd_ms']:.3f} ms vs plain {r['fwd_plain_ms']:.1f} ms "
                  f"(turns {kf1:.3f}/{kf2:.3f} vs {pf1:.1f}/{pf2:.1f}); "
                  f"fwd+bwd kernel {kfb:.3f} ms vs plain {pfb:.1f} ms; "
                  f"bwd kernel {kb:.3f} ms vs plain {pb:.1f} ms; "
                  f"max abs err fwd {abs_f:.3e} bwd {abs_b:.3e}")
    return results


def _norm_err_t(a: torch.Tensor, b: torch.Tensor) -> float:
    return _norm_err(a.float().cpu(), b.float().cpu())


def phase5_extractor(slam, dev):
    from online_lang_splatting_tpu_torch.models.autoencoder import ONE_STAGE_DEC, ONE_STAGE_ENC
    from online_lang_splatting_tpu_torch.models.convnext_clip import normalize_image, resize_bilinear
    from online_lang_splatting_tpu_torch.models.sed import LangFeatureExtractor

    ex = slam.backend.lang_extractor
    color = slam.dataset[0][0]
    rgb = torch.as_tensor(color, device=dev).permute(1, 2, 0) * 255.0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    code = ex.encode_frame(rgb)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    norms = torch.linalg.norm(code, dim=-1)
    norm_dev = float((norms - 1).abs().max())
    print(f"[phase5] encode_frame {tuple(rgb.shape)} -> {tuple(code.shape)} at clip "
          f"resolution {ex.clip_resolution}; max | |code| - 1 | {norm_dev:.2e}; "
          f"peak memory {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above "
          f"the {base / 2**20:.1f} MiB held before the call)")
    if tuple(code.shape) != (192, 192, 15) or not bool(torch.isfinite(code).all()):
        raise AssertionError(f"extractor output {tuple(code.shape)} not finite (192, 192, 15)")
    if not norm_dev <= UNIT_NORM_TOL:
        raise AssertionError(f"codes not unit-norm: {norm_dev}")

    # The same seeded weights on the CPU, at a reduced clip resolution.
    t0 = time.time()
    cpu = LangFeatureExtractor(encoder_dims=ONE_STAGE_ENC, decoder_dims=ONE_STAGE_DEC,
                               use_hr=ex.hr is not None, clip_resolution=(128, 128),
                               device="cpu")
    for name in ("visual", "hr", "ae"):
        a, b = getattr(ex, name).state_dict(), getattr(cpu, name).state_dict()
        if any(not torch.equal(a[k].cpu(), b[k]) for k in a):
            raise AssertionError(f"seeded {name} weights differ between the card and the CPU")
    full_res = ex.clip_resolution
    ex.clip_resolution = (128, 128)
    try:
        small = {"encode_frame": ex.encode_frame(rgb), "hr_features": ex.hr_features(rgb)}
    finally:
        ex.clip_resolution = full_res
    rgb_cpu = rgb.cpu()
    ref = {"encode_frame": cpu.encode_frame(rgb_cpu), "hr_features": cpu.hr_features(rgb_cpu)}
    cpu_errs = {k: _norm_err_t(small[k], ref[k]) for k in small}
    print(f"[phase5] card vs CPU at 128^2 on the same weights (CPU build+run "
          f"{time.time() - t0:.1f} s): " + json.dumps(cpu_errs) + f" (tol {EXTRACTOR_TOL})")
    for k, v in cpu_errs.items():
        if not v <= EXTRACTOR_TOL:
            raise AssertionError(f"extractor {k} card vs CPU error {v} > {EXTRACTOR_TOL}")

    with torch.no_grad():
        x = resize_bilinear(normalize_image(rgb).permute(2, 0, 1)[None], full_res)
        feats = ex.visual(x)
        times = {
            "encode_frame_ms": _time(lambda: ex.encode_frame(rgb), 10),
            "tower_ms": _time(lambda: ex.visual(x), 10),
            "hr_head_ms": _time(lambda: ex.hr(feats["clip_vis_dense"], feats["res3"],
                                              feats["res2"]), 10),
        }
    print("[phase5] median of 10 after warm-up (CUDA events): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return dict(times, peak_mib=peak / 2**20, peak_above_base_mib=(peak - base) / 2**20,
                unit_norm_dev=norm_dev, card_vs_cpu=cpu_errs)


def phase6_miou(config_path: str, dev):
    """The synthetic mIoU harness twice on the same frames: with the
    two-stage online codec, then with the one-stage codec."""
    import tempfile

    from online_lang_splatting_tpu_torch.eval.synthetic_miou import run_synthetic_miou
    from online_lang_splatting_tpu_torch.ops.raster import tiled
    from online_lang_splatting_tpu_torch.slam.config import load_config

    results = {}
    for stage in (2, 1):
        config = load_config(config_path)
        # The harness ray-casts and hashes every frame of the dataset when
        # it is built: keep the dataset to the frames the run reads.
        config["Dataset"]["num_frames"] = MIOU_FRAMES
        config["language"]["allow_zero_supervision"] = False
        tiled.FWD_STATS.reset()
        tiled.BWD_STATS.reset()
        t0 = time.time()
        with tempfile.TemporaryDirectory() as out_dir:
            res = run_synthetic_miou(config, max_frames=MIOU_FRAMES, every=1, stage=stage,
                                     train_steps=300, out_dir=out_dir, device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _launch_counts(tiled)
        res.update(wall_s=wall, launches=counts)
        min_miou = GATE_MIOU_STAGE[stage]
        where = f"phase6 stage {stage}"
        print(f"[{where}] {MIOU_FRAMES} frames: mIoU {res['miou']:.4f} (gate {min_miou}), "
              f"localization {res['localization_acc']:.4f} (gate {GATE_LOC}), "
              f"{res['distinct_queries']} distinct queries / {res['num_queries']} scored "
              f"(gate {GATE_QUERIES}), {res['frames_scored']} frames scored (gate {GATE_FRAMES}), "
              f"AE round-trip cosine {res['ae_roundtrip_cos']:.4f} (gate {GATE_AE_COS})")
        print(f"[{where}] keyframes {res['keyframes']}, online-AE steps {res['online_ae_steps']}, "
              f"eval PSNR {res['eval_psnr']:.3f} dB; multilevel " + json.dumps(res["multilevel"]))
        print(f"[{where}] wall {wall:.2f} s: setup {res['setup_s']:.2f} s, SLAM "
              f"{res['slam_s']:.2f} s, eval {res['eval_s']:.2f} s; phase times "
              + json.dumps({k: round(v, 3) for k, v in res["phase_times"].items()})
              + f"; launches {json.dumps(counts)}")
        _check_launches(counts, where)
        gates = [("mIoU", res["miou"] >= min_miou),
                 ("localization", res["localization_acc"] >= GATE_LOC),
                 ("queries", res["distinct_queries"] >= GATE_QUERIES),
                 ("frames", res["frames_scored"] >= GATE_FRAMES),
                 ("AE round trip", res["ae_roundtrip_cos"] > GATE_AE_COS)]
        failed = [name for name, ok in gates if not ok]
        if failed:
            raise AssertionError(f"{where} gates failed: {failed}")
        results[f"stage{stage}"] = res
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--config", default=str(REPO / "configs/synthetic/replica_scale.yaml"))
    args = ap.parse_args(argv)

    smi = phase0_device()
    # Full float32 for matmuls and convolutions (TF32 off), as the JAX
    # reference pins "highest" precision for the geometry.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    phase1_build()
    phase2_goldens(dev)
    slam, counts, main_path = phase3_main_path(args.config, args.frames, dev)
    times = phase4_times(slam, dev)
    extractor = phase5_extractor(slam, dev)
    del slam
    miou = phase6_miou(args.config, dev)

    r15 = times[15]
    kernels = [
        {"name": "blend_fwd", "route": "cuda",
         "source": "online_lang_splatting_tpu_torch/csrc/blend_fwd.cu",
         "replaces": "online_lang_splatting_tpu/ops/raster/tiled.py:405",
         "launches": counts["fwd_launches"], "max_abs_err": r15["fwd_abs_err"],
         "ms": r15["fwd_ms"], "plain_ms": r15["fwd_plain_ms"]},
        {"name": "blend_bwd", "route": "cuda",
         "source": "online_lang_splatting_tpu_torch/csrc/blend_bwd.cu",
         "replaces": "online_lang_splatting_tpu/ops/raster/tiled.py:633",
         "launches": counts["bwd_launches"], "max_abs_err": r15["bwd_abs_err"],
         "ms": r15["bwd_ms"], "plain_ms": r15["bwd_plain_ms"]},
    ]
    print(f"[done] card {smi}")
    print(json.dumps({"language": {"card": smi, "main_path": main_path,
                                   "extractor": extractor, "miou": miou}}, default=float))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

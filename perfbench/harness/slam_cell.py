"""SLAM cells: the port's `SLAM.run` (single-thread) on frames the
benchmark writes in the Replica-v2 layout and the port reads back, with
the language supervision of the port's extractor on the benchmark's
weights.

Set-up writes the frames, draws the weights, builds the extractor, the
language codec the configuration names (with `single_stage` false, the
two-stage online autoencoder) and the SLAM as `slam_torch.main` builds
them, and runs frame 0 (the map's initialisation) inside the one
`SLAM.run` call. A wrapper around the instance's `_camera` opens the
window when frame 1 is requested and, at the first request after the
window's length that `window_closes` allows, raises `StopWindow`, which
ends the call at a frame boundary (the run's own `finally` stops the
prefetch threads). Other wrappers keep the inputs and outputs of the
window's last mapping iteration and of its last online-codec steps. After
the window the check compares what the window produced with the
benchmark's plain references."""

from __future__ import annotations

import copy
import gc
import math
import shutil
import time

import numpy as np
import torch

from perfbench.harness import counts, scene, weights
from perfbench.harness.common import ROOT, StopWindow, rel_fro, rel_mean_abs
from perfbench.reference import extractor as ref_extractor
from perfbench.reference import mapping as ref_mapping
from perfbench.reference import online_ae as ref_online_ae
from perfbench.reference import raster as ref_raster

WORK = ROOT / "build" / "perfbench"


class FrameClock:
    """Wraps `slam._camera`: opens the window at frame 1's request and
    raises StopWindow at the first request for which `should_stop(idx)`
    holds."""

    def __init__(self, slam, should_stop, on_open=None, on_close=None):
        self._inner = slam._camera
        self.should_stop = should_stop
        self.on_open, self.on_close = on_open, on_close
        self.t_open = self.t_close = None
        self.first = self.stopped_at = None
        slam._camera = self

    def __call__(self, idx: int):
        if idx >= 1:
            if self.t_open is None:
                if self.on_open is not None:
                    self.on_open()
                self.first = idx
                self.t_open = time.time()
            elif self.should_stop(idx):
                self.t_close = time.time()
                self.stopped_at = idx
                if self.on_close is not None:
                    self.on_close()
                raise StopWindow
        return self._inner(idx)


def window_closes(idx: int, elapsed: float, made: list, length: float,
                  hold_until: float | None = None) -> bool:
    """Whether the window closes at the request of frame idx, `elapsed`
    seconds after it opened, having made the keyframes `made`. Past its
    length it closes at the end of a keyframe's mapping (frame idx - 1 was a
    keyframe), so that it holds whole keyframe cycles, or past 1.5 times
    the length. A window that has made no keyframe by then closes at once;
    with `hold_until` it runs on to the end of its first keyframe's mapping
    instead, or to `hold_until` seconds, so that a traced window's mapping
    metrics have a keyframe to read."""
    if elapsed < length:
        return False
    if not made:
        return hold_until is None or elapsed >= hold_until
    return idx - 1 in made or elapsed >= 1.5 * length


class BlendRecorder:
    """Shapes of every blend call while recording, and the inputs of a few
    forward calls per channel count, whose pairs are counted after the
    window."""

    SAMPLE_EVERY, SAMPLES = 97, 4

    def __init__(self, tiled):
        self.tiled = tiled
        self.calls: list = []
        self.samples: dict = {}
        self._seen: dict = {}
        self._fwd, self._bwd = tiled.blend_forward, tiled.blend_backward
        self.on = False

        def fwd(geom, feat, s_gid, starts, tile_counts, *, width, height, tile, **kw):
            if self.on:
                c = feat.shape[1]
                self.calls.append(("fwd", feat.shape[0], s_gid.shape[0], c, height, width, tile))
                k = self._seen[c] = self._seen.get(c, 0) + 1
                taken = self.samples.setdefault(c, [])
                if k % self.SAMPLE_EVERY == 1 and len(taken) < self.SAMPLES:
                    taken.append((geom.clone(), s_gid.clone(), starts.clone(),
                                  tile_counts.clone(), width, height, tile))
            return self._fwd(geom, feat, s_gid, starts, tile_counts, width=width,
                             height=height, tile=tile, **kw)

        def bwd(geom, feat, s_gid, starts, tile_counts, *args, width, height, tile, **kw):
            if self.on:
                self.calls.append(("bwd", feat.shape[0], s_gid.shape[0], feat.shape[1], height,
                                   width, tile))
            return self._bwd(geom, feat, s_gid, starts, tile_counts, *args, width=width,
                             height=height, tile=tile, **kw)

        tiled.blend_forward, tiled.blend_backward = fwd, bwd

    def restore(self):
        self.tiled.blend_forward, self.tiled.blend_backward = self._fwd, self._bwd

    def totals(self) -> dict | None:
        """Per direction, the sums over the recorded calls of the roofline
        bound and of the operations, with each call's pairs estimated from
        the sampled calls of its channel count (pairs per instance)."""
        ratio = {}
        for c, taken in self.samples.items():
            ev = co = inst = 0
            for geom, s_gid, starts, tc, w, h, tile in taken:
                e, k = counts.blend_work(geom, s_gid, starts, tc, width=w, height=h, tile=tile)
                ev, co, inst = ev + e, co + k, inst + s_gid.numel()
            if inst:
                ratio[c] = (ev / inst, co / inst)
        out = {k: {"bound_s": 0.0, "flops": 0.0, "calls": 0} for k in ("fwd", "bwd")}
        for kind, p, n, c, h, w, tile in self.calls:
            if c not in ratio:
                return None
            fl = counts.blend_flops(kind, c, ratio[c][0] * n, ratio[c][1] * n)
            t = out[kind]
            t["bound_s"] += counts.bound_s(fl, counts.blend_bytes(kind, p, n, c, h, w, tile))
            t["flops"] += fl
            t["calls"] += 1
        return out


class MapRecorder:
    """Wraps the backend's `mapping_iteration`: while on, keeps the last
    call's arguments, the Gaussian gradients its `slot_grads` returned and
    the map it returned (references only: the program replaces, and never
    writes into, the tensors of its map and optimizer state)."""

    def __init__(self, backend_module):
        self.module = backend_module
        self._inner = inner = backend_module.mapping_iteration
        self.on = False
        self.last = None

        def recorded(*args, slot_grads, **kw):
            if not self.on:
                return inner(*args, slot_grads=slot_grads, **kw)
            box = {}

            def grads(*a, **k):
                out = slot_grads(*a, **k)
                box["grads"] = out[0]
                return out

            out = inner(*args, slot_grads=grads, **kw)
            self.last = dict(args=args, kw=kw, grads=box["grads"], params=out[0])
            return out

        backend_module.mapping_iteration = recorded

    def restore(self):
        self.module.mapping_iteration = self._inner


class OnlineAERecorder:
    """Wraps the two-stage codec's `_step` and `train_and_encode` on the
    trainer: while on, keeps the last step's rows, its leaves, Adam moments
    and count before the step and its leaves after it (copied into one
    flat tensor each time: the optimizer updates them in place), and the
    last step that an extraction made (`last_extract`)."""

    def __init__(self, trainer):
        opt = trainer.optimizer
        self.names = [n for n, _ in trainer.model.named_parameters()]
        self.shapes = [p.shape for p in opt.params]
        self.on = False
        self.last = self.last_extract = None
        step, encode = trainer._step, trainer.train_and_encode

        def flat(tensors):
            return torch.cat([t.detach().reshape(-1) for t in tensors])

        def recorded_step(codes32):
            if not self.on:
                return step(codes32)
            before, count = flat(opt.params + opt.mu + opt.nu), opt.count
            out = step(codes32)
            self.last = dict(x=codes32, before=before, after=flat(opt.params), count=count)
            return out

        def recorded_encode(codes32):
            out = encode(codes32)  # its step goes through recorded_step
            if self.on:
                self.last_extract = self.last
            return out

        trainer._step, trainer.train_and_encode = recorded_step, recorded_encode

    def leaves(self, vec) -> list:
        """A flat copy cut back into dicts of leaves by name: [params] from
        `after`, [params, mu, nu] from `before`."""
        out, pos = [], 0
        while pos < vec.numel():
            group = {}
            for name, shape in zip(self.names, self.shapes):
                n = math.prod(shape)
                group[name] = vec[pos:pos + n].view(shape)
                pos += n
            out.append(group)
        return out


def _sync():
    torch.cuda.synchronize()


def build(cfg: dict, traffic: dict, seed: int, device):
    """Frames on disk, the extractor on the seed's weights, and the SLAM."""
    from online_lang_splatting_tpu_torch.slam.system import SLAM

    slam_cfg = copy.deepcopy(cfg["slam"])
    frames = WORK / "frames"
    shutil.rmtree(frames, ignore_errors=True)
    written = scene.write_replicav2(frames, traffic["frames"], traffic["trajectory_frames"],
                                    slam_cfg["Dataset"]["Calibration"], device)
    slam_cfg["Dataset"]["dataset_path"] = str(frames)
    extractor = weights.extractor(cfg["extractor"], seed, device,
                                  use_hr=slam_cfg["language"]["hr_model"])
    online_ae = None
    if not slam_cfg["language"].get("single_stage", True):
        from online_lang_splatting_tpu_torch.models.checkpoints import OnlineAETrainer

        online_ae = OnlineAETrainer(device=device)  # as load_extractor_from_dir makes it
    slam = SLAM(slam_cfg, lang_extractor=extractor, online_ae=online_ae, device=device)
    return slam, written


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        control: str | None = None, should_stop=None) -> dict:
    """One run of a SLAM cell; returns the pieces of the result line and
    the per-layer context. The device's peak memory is read as the window
    closes, before the references run."""
    from online_lang_splatting_tpu_torch import entry_device
    from online_lang_splatting_tpu_torch.ops.raster import tiled
    from online_lang_splatting_tpu_torch.slam import backend

    cfg, traffic = cell["config"], cell["traffic"]
    device = entry_device(device)
    on_card = device.type == "cuda"
    slam, written = build(cfg, traffic, seed, device)
    if control == "tf32":  # the program's own lower precision, after its pinning
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    fe, be = slam.frontend, slam.backend
    length = min(seconds, traffic["trace_seconds"]) if trace else seconds
    prof = spans = recorder = None
    if trace:
        from perfbench.harness.tracer import Profile, Spans

        prof, spans = Profile(), Spans(sync=_sync)
        spans.wrap(fe, "track", "track")
        spans.wrap(be, "map", "map")
        spans.wrap(be, "ensure_lang_features", "extract")
        spans.wrap(slam, "_camera", "data")
        recorder = BlendRecorder(tiled)
    mapping = MapRecorder(backend)
    online = OnlineAERecorder(be.online_ae) if be.online_ae is not None else None
    snap: dict = {}

    def on_open():
        t0 = time.time()
        snap.update(phase=dict(slam.phase_times), iters=len(fe.track_iters),
                    map_iters=be.iteration_count, extract_s=be.lang_extract_s,
                    kfs=len(fe.kf_indices), live_open=int(be.aux.active.sum()))
        if on_card:
            torch.cuda.synchronize()
        mapping.on = True
        if online is not None:
            online.on = True
        if trace:
            recorder.on = True
            prof.start()
        # The program's clock of frame 1's data phase runs through this call.
        snap["open_s"] = time.time() - t0

    def on_close():
        mapping.on = False
        if online is not None:
            online.on = False
        if trace:
            prof.stop(_sync)
            recorder.on = False

    if should_stop is None:
        # A traced window holds a keyframe, up to an untraced window's cap.
        hold_until = 1.5 * seconds if trace else None

        def should_stop(idx):
            made = [k for k in fe.kf_indices if k >= clock.first]
            return window_closes(idx, time.time() - clock.t_open, made, length, hold_until)

    clock = FrameClock(slam, should_stop, on_open, on_close)
    try:
        slam.run()
        clock.t_close = time.time()
        on_close()
    except StopWindow:
        pass
    finally:
        mapping.restore()
        if recorder is not None:
            recorder.restore()
    last = (clock.stopped_at if clock.stopped_at is not None else len(slam.dataset)) - 1
    frames_done = last - clock.first + 1
    window_s = clock.t_close - clock.t_open
    window_kfs = [k for k in fe.kf_indices if k >= clock.first]
    ctx = dict(kind="slam", frames=frames_done, window_s=window_s,
               phase_s={k: slam.phase_times[k] - snap["phase"].get(k, 0.0)
                        - (snap["open_s"] if k == "data" else 0.0) for k in slam.phase_times},
               track_iters=int(sum(fe.track_iters[snap["iters"]:])),
               map_iters=be.iteration_count - snap["map_iters"],
               extract_s=be.lang_extract_s - snap["extract_s"], extractions=len(window_kfs),
               keyframes=len(fe.kf_indices) - snap["kfs"],
               live_open=snap["live_open"], live_close=int(be.aux.active.sum()),
               capacity=be.aux.active.numel(), map_bytes=_map_bytes(be),
               extract_flops=counts.extractor_flops(cfg["extractor"]))
    out = dict(ctx=ctx, frames=frames_done, window_s=window_s,
               e2e={"slam_fps": frames_done / window_s, "setup_s": clock.t_open - t_start},
               peak=torch.cuda.max_memory_allocated() if on_card else 0)
    # What the window produced, taken before the program's state is freed.
    numbers_in = _program_outputs(slam, clock.first, last, window_kfs, online)
    numbers_in["map_step"] = mapping.last
    numbers_in["window_keyframes"] = len(window_kfs)
    del slam, fe, be, clock, mapping, online
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if trace:
        ctx.update(trace=prof.reduce(), spans=spans, blend=recorder.totals())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["numbers"], out["failed"], out["detail"] = check(cfg, traffic, seed, device, numbers_in)
    out["detail"]["frames_written_bytes"] = written
    out["attempted"] = frames_done
    return out


def _map_bytes(be) -> int:
    """Bytes of the map on the card: its parameters and their Adam moments."""
    trees = (be.params, be.opt.mu, be.opt.nu)
    return sum(x.numel() * x.element_size() for tree in trees for x in tree)


@torch.no_grad()
def _program_outputs(slam, first: int, last: int, window_kfs: list, online=None) -> dict:
    """What the check compares, taken before the program's state is freed.
    `codes` are the extractor's codes of the window's keyframes: the
    supervision itself in one stage, the 32-d codes the online codec
    compresses in two. `online`: the codec's last step, the last step an
    extraction made and the supervision that extraction stored."""
    from online_lang_splatting_tpu_torch.slam.renderer import activate, render

    fe, be = slam.frontend, slam.backend
    stack = be.frame_stack
    poses = {i: (fe.cameras[i].r.copy(), fe.cameras[i].t.copy()) for i in range(first, last + 1)}
    kept = stack.cocos if online is not None else stack.langs
    codes = {k: kept[k] for k in window_kfs if k in kept}
    codec = None
    if online is not None:
        ext = online.last_extract
        sup = None
        if ext is not None:  # the keyframe whose 32-d codes that step took
            sup = next((stack.langs.get(k) for k, v in stack.cocos.items() if v is ext["x"]),
                       None)
        codec = dict(recorder=online, step=online.last, extract=ext, supervision=sup)
    p = be.params
    params = dict(xyz=p.xyz, features_dc=p.features_dc, opacity=p.opacity, scaling=p.scaling,
                  rotation=p.rotation, language=p.language, active=be.aux.active)
    params = {k: v.detach().clone() for k, v in params.items()}
    cam = fe.cameras[last]
    w2c = torch.as_tensor(cam.world_view_transform, device=slam.device)
    img = render(activate(be.params, be.aux.active), w2c, slam.proj, slam.settings)
    rendered = dict(color=img.color, language=img.language, depth=img.depth)
    return dict(poses=poses, codes=codes, params=params, w2c=w2c, rendered=rendered,
                tile=slam.settings.tile, online=codec)


def check(cfg: dict, traffic: dict, seed: int, device, got: dict) -> tuple[dict, int, dict]:
    """The compared numbers: the largest rotation error (radians) of the
    window's tracked frames against the written trajectory; the render of the map
    the window left, at the last frame's tracked pose, against the plain
    render of the same map (mean absolute error over the mean magnitude,
    worst of colour, language and depth); the window's keyframe codes
    against the plain extractor on the frames as written (Frobenius error
    over the reference's norm, worst keyframe; in two stages the 32-d
    codes); the window's last mapping iteration against the plain one from
    the same map, poses, frames and optimizer state (`_mapping_numbers`);
    and in two stages the online codec's last steps (`_online_numbers`),
    None in one."""
    calib = cfg["slam"]["Dataset"]["Calibration"]
    traj = traffic["trajectory_frames"]
    failed = 0
    rot_err = 0.0
    centre, angle = {}, {}
    for i, (r, t) in got["poses"].items():
        if not (np.isfinite(r).all() and np.isfinite(t).all()):
            failed += 1
            rot_err = math.inf
            continue
        true = scene.pose(i, traj)
        r = r.astype(np.float64)
        centre[i] = float(np.linalg.norm(-r.T @ t.astype(np.float64)
                                         + true[:3, :3].T @ true[:3, 3]))
        rel = r @ true[:3, :3].T  # the angle of the relative rotation, by atan2
        sin = 0.5 * np.linalg.norm([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                                    rel[1, 0] - rel[0, 1]])
        angle[i] = float(np.arctan2(sin, (np.trace(rel) - 1.0) / 2.0))
        rot_err = max(rot_err, angle[i])
    ref = ref_raster.render(got["params"], got["w2c"], fx=calib["fx"], fy=calib["fy"],
                            cx=calib["cx"], cy=calib["cy"], width=calib["width"],
                            height=calib["height"], tile=got["tile"])
    render_err = max(rel_mean_abs(got["rendered"][k], ref[k])
                     for k in ("color", "language", "depth"))
    code_err = None
    if got["codes"]:
        w = weights.draw(cfg["extractor"], seed, device)
        tex = torch.as_tensor(scene.texture(), device=device)
        inv255 = torch.tensor(1.0 / 255.0, dtype=torch.float32)
        code_err = 0.0
        for k, prog in got["codes"].items():
            rgb, _ = scene.frame_u8(scene.pose(k, traj), tex, calib, float(calib["depth_scale"]))
            frame = torch.as_tensor(rgb, device=device).float() * inv255.to(device) * 255.0
            want = ref_extractor.encode_frame(frame, w, cfg["extractor"])
            want = want.permute(2, 0, 1) if prog.dim() == 3 else want.reshape(prog.shape)
            code_err = max(code_err, rel_fro(prog, want))
        del w
    map_grad_err = map_step_err = None
    detail = {"rot_err_rad": angle, "centre_err_m": centre}
    if got["map_step"] is not None:
        map_grad_err, map_step_err, detail["map_leaves"] = _mapping_numbers(
            got["map_step"], calib, got["tile"])
    elif got["window_keyframes"]:  # keyframes made and no mapping iteration ran
        map_grad_err = map_step_err = math.inf
    online_step_err = online_code_err = None
    if got["online"] is not None:
        online_step_err, online_code_err, detail["online_leaves"] = _online_numbers(
            got["online"], got["window_keyframes"])
    numbers = dict(pose_rot_err_rad=rot_err, render_rel_err=render_err, lang_code_err=code_err,
                   map_grad_err=map_grad_err, map_step_err=map_step_err,
                   online_ae_step_err=online_step_err, online_code_err=online_code_err)
    return numbers, failed, detail


def _norm(x) -> float:
    return float(x.double().norm())


def _gap(a: float, b: float, den: float) -> float:
    return abs(a - b) / den if den > 0 else (0.0 if a == b else math.inf)


def _mapping_numbers(rec: dict, calib: dict, tile: int) -> tuple[float, float, dict]:
    """The window's last mapping iteration against the plain reference,
    from the program's map, slot poses, exposures, frames, language
    supervision and Adam state as that iteration received them:
    `map_grad_err`, over the compared leaves the largest gap between the
    norms of the program's and the reference's Gaussian gradient, over
    the larger of the reference leaf's norm and the median leaf's;
    `map_step_err`, the same of the leaves' change in that step. Gaps of
    norms, not norms of differences: the L1 losses' gradients are sums of
    signs, and a residual within rounding of zero that takes the other
    sign moves a difference by ~1 / sqrt(pixels). A leaf whose reference
    gradient is under a thousandth of the median leaf's is not compared
    (its Adam step is round-off)."""
    (params, opt, aux, _proj, slot_r, slot_t, slot_ea, slot_eb, _pm, _pv, _pt, images, depths,
     langs, valid, lang_on, _po, _eo, lrs, lang_weight) = rec["args"]
    init_mode = bool(rec["kw"]["init_mode"])
    active = aux.active
    leaves = ref_mapping.LEAVES
    before = {k: getattr(params, k).detach().float() for k in leaves}
    ref = {k: torch.zeros_like(v) for k, v in before.items()}
    for s_ in range(len(valid)):
        if not valid[s_]:
            continue
        w2c = torch.eye(4, dtype=torch.float32, device=before["xyz"].device)
        w2c[:3, :3], w2c[:3, 3] = slot_r[s_].float(), slot_t[s_].float()
        g = ref_mapping.slot_grads(
            before, active, w2c, images[s_].float(), depths[s_].float(), langs[s_].float(),
            lang_on=bool(lang_on[s_]), ea=slot_ea[s_].float(), eb=slot_eb[s_].float(),
            lang_weight=float(lang_weight), init_mode=init_mode, fx=calib["fx"],
            fy=calib["fy"], cx=calib["cx"], cy=calib["cy"], width=calib["width"],
            height=calib["height"], tile=tile)
        for k in leaves:
            ref[k] += g[k]
    norms = {k: _norm(ref[k]) for k in leaves}
    med = float(np.median(list(norms.values())))
    if max(norms.values()) == 0.0:  # no live Gaussian in view: no sound run's map
        return math.inf, math.inf, {}
    use = [k for k in leaves if norms[k] > 0.0 and norms[k] >= 1e-3 * med]
    grad_gap = {k: _gap(_norm(getattr(rec["grads"], k)), norms[k], max(norms[k], med))
                for k in use}
    total = dict(ref)
    total["scaling"] = total["scaling"] + ref_mapping.isotropic_grad(before["scaling"], active)
    after = ref_mapping.adam(before, total, {k: getattr(opt.mu, k).float() for k in leaves},
                             {k: getattr(opt.nu, k).float() for k in leaves}, opt.count,
                             {k: getattr(lrs, k) for k in leaves}, active)
    step_ref = {k: _norm(after[k] - before[k]) for k in use}
    step_prog = {k: _norm(getattr(rec["params"], k).float() - before[k]) for k in use}
    smed = float(np.median(list(step_ref.values())))
    step_gap = {k: _gap(step_prog[k], step_ref[k], max(step_ref[k], smed)) for k in use}
    detail = {k: [grad_gap[k], step_gap[k]] for k in use}
    return max(grad_gap.values()), max(step_gap.values()), detail


def _online_numbers(got: dict, window_keyframes: int) -> tuple:
    """The two-stage codec against the plain reference from the program's
    own state before each compared step: `online_ae_step_err`, the
    window's last step, over the leaves the worst gap between the norms of
    the program's and the reference's change of the leaf, over the larger
    of the reference leaf's change and the median leaf's (the L1 loss's
    gradient is a sum of signs, as in `_mapping_numbers`; a leaf whose
    reference gradient is under a thousandth of the median leaf's is not
    compared); `online_code_err`, the supervision the window's last
    extraction stored against the reference's step and then encoding of
    that step's rows (Frobenius, relative). A window that made keyframes
    and no step, or no stored supervision, reads inf; one with no keyframe
    reads None."""
    rec = got["recorder"]

    def reference(step):
        p, mu, nu = rec.leaves(step["before"])
        x = step["x"].float()
        g = ref_online_ae.grads(x, p)
        return p, g, ref_online_ae.adam(p, g, mu, nu, step["count"]), x

    step_err = code_err = math.inf if window_keyframes else None
    detail = {}
    if got["step"] is not None:
        p, g, after, _ = reference(got["step"])
        (prog,) = rec.leaves(got["step"]["after"])
        norms = {k: _norm(g[k]) for k in ref_online_ae.LEAVES}
        med = float(np.median(list(norms.values())))
        use = [k for k in ref_online_ae.LEAVES if norms[k] > 0.0 and norms[k] >= 1e-3 * med]
        step_ref = {k: _norm(after[k] - p[k]) for k in use}
        smed = float(np.median(list(step_ref.values()))) if use else 0.0
        detail = {k: _gap(_norm(prog[k].float() - p[k]), step_ref[k], max(step_ref[k], smed))
                  for k in use}
        step_err = max(detail.values()) if detail else math.inf
    if got["extract"] is not None and got["supervision"] is not None:
        _, _, after, x = reference(got["extract"])
        sup = got["supervision"]
        want = ref_online_ae.encode(x, after)
        code_err = rel_fro(sup.permute(1, 2, 0).reshape(want.shape), want)
    return step_err, code_err, detail

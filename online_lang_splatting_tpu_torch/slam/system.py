"""SLAM orchestration (port of slam/system.py): the frontend and backend
run in lock step on one thread (`run_single_thread`) or on two host
threads (`run_threaded`, config `Training.single_thread: False`), as the
config says (`run`). `lang_extractor` (models/sed.py or the synthetic
harness's) supervises the language channels of each keyframe, and
`online_ae` (models/checkpoints.OnlineAETrainer) is the two-stage codec
trained in the loop. Frames are decoded and uploaded ahead of the loop
(slam/prefetch.py) unless `Dataset.prefetch` is false.

`Results.use_gui: true` writes the headless viewer's PNG mosaics of the map
(gui/viewer.py); `"interactive"` opens the open3d window (gui/slam_gui.py)
and falls back to the headless viewer without open3d. `mesh_devices: N`
spreads the work over the first N cards (parallel/): mapping shards the
keyframe slots and tracking renders band-parallel; a caller may instead
pass a `mesh` that names its devices.

Threaded mode's messages (as in the JAX package and the reference):
  frontend -> backend: ["init", idx, cam, depthmap] |
                       ["keyframe", idx, cam, window, depthmap] | ["stop"]
  backend -> frontend: ["sync_backend", render_inputs, occ_vis, kf_poses] |
                       ["init_done"] | ["keyframe_done", idx]
Both threads launch on the device's default stream, which the card runs in
order. The backend replaces the map's tensors on every update and never
writes them in place (models/gaussians.py returns new tensors), and each
snapshot it hands over copies the two tensors `activate` passes through,
so a snapshot the frontend renders never changes under it.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import pin_f32_matmul
from ..gui.viewer import GaussianPacket
from ..ops.raster import RasterSettings
from .backend import BackEnd
from .camera import Camera, camera_projection
from .datasets import load_dataset
from .frontend import FrontEnd
from .renderer import activate


class _QueueViewer:
    """The viewer interface over the interactive GUI's packet queue."""

    def __init__(self, q):
        self.q = q

    def submit(self, pkt):
        try:
            self.q.put_nowait(pkt)
        except queue.Full:
            pass

    def close(self):
        self.q.put(GaussianPacket(finish=True))


class SLAM:
    def __init__(self, config: dict, lang_extractor=None, online_ae=None,
                 device="cuda", save_dir: Optional[Path] = None, mesh=None):
        pin_f32_matmul()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        if mesh is None and config.get("mesh_devices", 0):
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(config["mesh_devices"], device=self.device)
        self.mesh = mesh
        self.config = config
        self.save_dir = save_dir
        self.dataset = load_dataset(config)
        self._campre = None
        if (config["Dataset"].get("prefetch", True)
                and config["Dataset"]["type"] != "realsense"  # a live stream
                and len(self.dataset) > 0):
            from .prefetch import CameraPrefetcher, PrefetchDataset

            self.dataset = PrefetchDataset(self.dataset)
            self._campre = CameraPrefetcher(self.dataset, config, self.device)
        calib = config["Dataset"]["Calibration"]
        width, height = calib["width"], calib["height"]
        self.settings = RasterSettings(
            image_height=height, image_width=width,
            tanfovx=math.tan(self.dataset.fovx / 2),
            tanfovy=math.tan(self.dataset.fovy / 2),
            sh_degree=config["model_params"]["sh_degree"],
            backend="cuda",
            tile=int(config.get("raster_tile", 32)),
        )
        self.proj = camera_projection(
            Camera(uid=-1, image=None, depth=None, r_gt=np.eye(3),
                   t_gt=np.zeros(3), fx=self.dataset.fx, fy=self.dataset.fy,
                   cx=self.dataset.cx, cy=self.dataset.cy,
                   fovx=self.dataset.fovx, fovy=self.dataset.fovy,
                   height=height, width=width),
            device=self.device)
        self.backend = BackEnd(config, self.settings, self.proj, self.device,
                               capacity=config.get("capacity", 1 << 17),
                               lang_extractor=lang_extractor, online_ae=online_ae,
                               mesh=mesh)
        self.frontend = FrontEnd(config, self.settings, self.device, mesh=mesh)
        self.use_every_n_frames = 1
        self.kf_interval = config["Training"]["kf_interval"]
        self.single_thread = config["Training"].get("single_thread", True)
        self.fps = None
        self.phase_times: dict = {}
        self.tracked_while_kf_in_flight = 0
        self.viewer = None
        self.q_vis2main: queue.Queue = queue.Queue()
        self._gui_paused = False
        use_gui = config.get("Results", {}).get("use_gui", False)
        if use_gui == "interactive":
            try:
                from ..gui import slam_gui

                params = slam_gui.ParamsGUI(
                    q_main2vis=queue.Queue(maxsize=4), q_vis2main=self.q_vis2main,
                    proj=self.proj, settings=self.settings)
                self._gui = slam_gui.SLAM_GUI(params)
                threading.Thread(target=self._gui.run, daemon=True).start()
                self.viewer = _QueueViewer(params.q_main2vis)
            except ImportError as e:
                print(f"[gui] {e}; using HeadlessViewer")
                use_gui = True
        if use_gui is True:
            from ..gui.viewer import HeadlessViewer

            self.viewer = HeadlessViewer(str(Path(save_dir or "results") / "viewer"))

    def _check_gui_pause(self):
        """Honour Packet_vis2main(flag_pause) from the interactive viewer:
        read every message queued, then wait while paused (the reference
        frontend's pause flow)."""
        while True:
            try:
                msg = (self.q_vis2main.get(timeout=0.05) if self._gui_paused
                       else self.q_vis2main.get_nowait())
            except queue.Empty:
                if self._gui_paused:
                    continue
                return
            self._gui_paused = bool(getattr(msg, "flag_pause", False))

    def _submit_view(self, idx: int, cam: Camera, last_kf: int, window):
        """Hand the viewer the map, the tracked camera and the keyframe
        window; the ground-truth language thumbnail is the latest
        keyframe's supervision (frames between keyframes have none)."""
        fe = self.frontend
        kf_cam = self.backend.viewpoints.get(last_kf)
        self.viewer.submit(GaussianPacket(
            render_inputs=fe.render_inputs, view=cam.world_view_transform,
            proj=self.proj, settings=self.settings, gtcolor=cam.image,
            gtdepth=cam.depth,
            gtlanguage=kf_cam.gt_lang_feat if kf_cam is not None else None,
            frame_idx=idx, keyframe_window=list(window),
            keyframe_poses=[fe.cameras[k].world_view_transform
                            for k in window if k in fe.cameras]
            + [cam.world_view_transform]))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _camera(self, idx: int) -> Camera:
        if self._campre is not None:
            return self._campre.get(idx)
        cam = Camera.from_dataset(self.dataset, idx, self.device)
        cam.compute_grad_mask(self.config)
        return cam

    def _create_kf(self, idx, last_kf, frames_since_kf, visibility, cur_window) -> bool:
        """The frontend's keyframe decision."""
        fe = self.frontend
        if len(cur_window) < fe.window_size:
            occ0 = fe.occ_aware_visibility.get(last_kf, visibility)
            union = np.count_nonzero(visibility | occ0)
            intersection = np.count_nonzero(visibility & occ0)
            return (frames_since_kf >= self.kf_interval
                    and intersection / max(union, 1) < self.config["Training"]["kf_overlap"])
        if last_kf in fe.occ_aware_visibility:
            return frames_since_kf >= self.kf_interval and fe.is_keyframe(
                idx, last_kf, visibility)
        return frames_since_kf >= self.kf_interval

    def close(self):
        """Stop the viewer and the prefetch threads and drop the frames they
        hold."""
        if self.viewer is not None:
            self.viewer.close()
            self.viewer = None
        if self._campre is not None:
            self._campre.close()
        if hasattr(self.dataset, "close"):
            self.dataset.close()

    def run(self, max_frames: Optional[int] = None, start_frame: int = 0,
            checkpoint_every: Optional[int] = None):
        """Single-threaded or threaded, as the config says; the prefetch
        threads stop when it returns."""
        try:
            if self.single_thread:
                return self.run_single_thread(max_frames, start_frame=start_frame,
                                              checkpoint_every=checkpoint_every)
            if start_frame or checkpoint_every:
                raise ValueError("checkpoints are taken and resumed in single-thread "
                                 "mode only, as in the JAX package")
            return self.run_threaded(max_frames)
        finally:
            self.close()

    def finalize(self, color_refinement_iters: Optional[int] = None):
        """Colour refinement of the final map (slam/refinement.py)."""
        if color_refinement_iters:
            t0 = time.time()
            self.backend.color_refinement(color_refinement_iters)
            self._sync_frontend_state()
            self._sync()
            self.phase_times["refine"] = time.time() - t0
        return self

    def _sync_frontend_state(self):
        """Give the frontend the backend's current map + keyframe poses."""
        self.frontend.render_inputs = activate(
            self.backend.params, self.backend.aux.active)
        self.frontend.occ_aware_visibility = dict(self.backend.occ_aware_visibility)
        for idx, cam in self.backend.viewpoints.items():
            if idx in self.frontend.cameras:
                self.frontend.cameras[idx].update_rt(cam.r, cam.t)

    def run_single_thread(self, max_frames: Optional[int] = None, start_frame: int = 0,
                          checkpoint_every: Optional[int] = None):
        t_start = time.time()
        n = len(self.dataset)
        if max_frames is not None:
            n = min(n, max_frames)
        fe, be = self.frontend, self.backend
        if start_frame > 0:  # resumed from a snapshot (slam/checkpoint.py)
            cur_window = list(be.current_window)
            last_kf = max(fe.kf_indices) if fe.kf_indices else 0
            frames_since_kf = max(start_frame - 1 - last_kf, 0)
        else:
            cur_window, last_kf, frames_since_kf = [], 0, 0
        last_ckpt = start_frame
        # Wall-clock per phase; each phase ends in a device sync so the
        # time lands on the phase that spent it.
        self.phase_times = {"data": 0.0, "track": 0.0, "map": 0.0,
                            "init": 0.0, "kf_insert": 0.0}

        def tick(phase, t0):
            self._sync()
            now = time.time()
            self.phase_times[phase] += now - t0
            return now

        for idx in range(start_frame, n):
            self._check_gui_pause()
            t0 = time.time()
            cam = self._camera(idx)
            fe.cameras[idx] = cam
            t0 = tick("data", t0)

            if idx == 0:
                cam.update_rt(cam.r_gt, cam.t_gt)
                be.add_next_kf(0, cam, fe.new_keyframe_depth(cam), init=True)
                be.initialize_map(0, cam)
                self._sync_frontend_state()
                tick("init", t0)
                cur_window = [0]
                fe.current_window = cur_window
                fe.kf_indices = [0]
                continue

            prev = fe.cameras[idx - self.use_every_n_frames]
            prev2 = fe.cameras.get(idx - 2 * self.use_every_n_frames)
            visibility = fe.track(cam, prev, self.proj, prev2=prev2)
            t0 = tick("track", t0)
            frames_since_kf += 1
            if self.viewer is not None:
                self._submit_view(idx, cam, last_kf, cur_window)
            if not self._create_kf(idx, last_kf, frames_since_kf, visibility, cur_window):
                cam.clean()
                continue

            cur_window, _removed = fe.add_to_window(idx, visibility, cur_window)
            fe.current_window = cur_window
            fe.kf_indices.append(idx)
            fe.occ_aware_visibility[idx] = visibility
            depthmap = fe.new_keyframe_depth(cam)
            be.viewpoints[idx] = cam
            be.current_window = cur_window
            be.add_next_kf(idx, cam, depthmap)
            be.reset_keyframe_optimizer(be._n_slots())
            t0 = tick("kf_insert", t0)
            be.map(cur_window, iters=be.mapping_itr_num, lang_run=be.lang_train)
            be.map(cur_window, prune=True)
            self._sync_frontend_state()
            tick("map", t0)
            last_kf = idx
            frames_since_kf = 0
            # Keyframes are irregular, so snapshot at the first keyframe at
            # least `checkpoint_every` frames after the previous snapshot.
            if checkpoint_every and idx - last_ckpt >= checkpoint_every:
                from . import checkpoint

                path = Path(self.save_dir or "results") / f"ckpt_{idx:06d}.npz"
                path.parent.mkdir(parents=True, exist_ok=True)
                checkpoint.save_state(self, path, idx + 1)
                last_ckpt = idx
                print(f"[checkpoint] saved {path}")

        self.fps = (n - start_frame) / (time.time() - t_start)
        return self

    def run_threaded(self, max_frames: Optional[int] = None):
        """Frontend on this thread, backend on a second one, sharing the
        card. The backend drains its queue (init / keyframe / stop) and maps
        the current window while idle, pushing a map snapshot every 10
        iterations; the frontend tracks every frame against its latest
        snapshot, keeps tracking while a keyframe request is in flight
        (counted in `tracked_while_kf_in_flight`) and creates keyframes
        only when none is. An exception in the backend thread is raised
        again here."""
        t_start = time.time()
        n = len(self.dataset)
        if max_frames is not None:
            n = min(n, max_frames)
        fe, be = self.frontend, self.backend
        frontend_queue: queue.Queue = queue.Queue()
        backend_queue: queue.Queue = queue.Queue()
        state = {"requested_kf": 0, "error": None}

        def push_snapshot():
            inputs = activate(be.params, be.aux.active)
            inputs = inputs._replace(xyz=inputs.xyz.clone(), language=inputs.language.clone())
            poses = {i: (c.r.copy(), c.t.copy()) for i, c in be.viewpoints.items()}
            frontend_queue.put(["sync_backend", inputs, dict(be.occ_aware_visibility), poses])

        def backend_loop():
            while True:
                try:
                    msg = backend_queue.get(timeout=0.01)
                except queue.Empty:
                    if be.initialized and be.current_window:
                        be.map(be.current_window, iters=1, lang_run=be.lang_train)
                        if be.iteration_count % 10 == 0:
                            push_snapshot()
                    continue
                if msg[0] == "stop":
                    return
                if msg[0] == "init":
                    _, idx, cam, depthmap = msg
                    be.add_next_kf(idx, cam, depthmap, init=True)
                    be.initialize_map(idx, cam)
                    be.current_window = [idx]
                    push_snapshot()
                    frontend_queue.put(["init_done"])
                elif msg[0] == "keyframe":
                    _, idx, cam, window, depthmap = msg
                    be.viewpoints[idx] = cam
                    be.current_window = list(window)
                    be.add_next_kf(idx, cam, depthmap)
                    be.reset_keyframe_optimizer(be._n_slots())
                    be.map(window, iters=be.mapping_itr_num, lang_run=be.lang_train)
                    be.map(window, prune=True)
                    push_snapshot()
                    frontend_queue.put(["keyframe_done", idx])

        def backend_main():
            try:
                backend_loop()
            except Exception as e:  # handed to the frontend, raised again there
                state["error"] = e

        def check_backend():
            if state["error"] is not None:
                raise RuntimeError("the backend thread failed") from state["error"]
            if not bt.is_alive():
                raise RuntimeError("the backend thread stopped unexpectedly")

        def drain(block=False):
            while True:
                try:
                    msg = frontend_queue.get(timeout=0.05 if block else 0.0)
                except queue.Empty:
                    return
                if msg[0] == "sync_backend":
                    _, inputs, occ, poses = msg
                    fe.render_inputs = inputs
                    fe.occ_aware_visibility = occ
                    for i, (r, t) in poses.items():
                        if i in fe.cameras:
                            fe.cameras[i].update_rt(r, t)
                else:  # init_done / keyframe_done
                    state["requested_kf"] = max(0, state["requested_kf"] - 1)
                if block and state["requested_kf"] == 0:
                    return

        def wait_for_backend():
            while state["requested_kf"] > 0:
                check_backend()
                drain(block=True)

        bt = threading.Thread(target=backend_main, name="slam-backend", daemon=True)
        bt.start()
        cur_window: list = []
        last_kf = frames_since_kf = 0
        self.tracked_while_kf_in_flight = 0
        try:
            for idx in range(n):
                self._check_gui_pause()
                t_frame = time.time()
                cam = self._camera(idx)
                fe.cameras[idx] = cam
                if idx == 0:
                    # The frontend waits for the map's initialisation.
                    cam.update_rt(cam.r_gt, cam.t_gt)
                    state["requested_kf"] = 1
                    backend_queue.put(["init", 0, cam, fe.new_keyframe_depth(cam)])
                    wait_for_backend()
                    cur_window = [0]
                    fe.kf_indices = [0]
                    continue
                check_backend()
                drain()
                visibility = fe.track(cam, fe.cameras[idx - 1], self.proj,
                                      prev2=fe.cameras.get(idx - 2))
                frames_since_kf += 1
                if state["requested_kf"] > 0:
                    # Tracked only: a keyframe request is in flight.
                    self.tracked_while_kf_in_flight += 1
                    cam.clean()
                    continue
                # Unlike the single-thread loop, a full window needs the last
                # keyframe's visibility from a snapshot, as in the JAX package.
                if not (self._create_kf(idx, last_kf, frames_since_kf, visibility, cur_window)
                        and (len(cur_window) < fe.window_size
                             or last_kf in fe.occ_aware_visibility)):
                    cam.clean()
                    continue
                cur_window, _ = fe.add_to_window(idx, visibility, cur_window)
                fe.kf_indices.append(idx)
                fe.occ_aware_visibility[idx] = visibility
                state["requested_kf"] += 1
                backend_queue.put(["keyframe", idx, cam, list(cur_window),
                                   fe.new_keyframe_depth(cam)])
                last_kf = idx
                frames_since_kf = 0
                # At most 3 frames per second after a keyframe insert.
                time.sleep(max(0.01, 1.0 / 3.0 - (time.time() - t_frame)))
            wait_for_backend()
        finally:
            backend_queue.put(["stop"])
            bt.join(timeout=600)
        if bt.is_alive():
            raise RuntimeError("the backend thread did not stop within 600 s")
        if state["error"] is not None:
            raise RuntimeError("the backend thread failed") from state["error"]
        self._sync_frontend_state()
        self._sync()
        self.fps = n / (time.time() - t_start)
        return self

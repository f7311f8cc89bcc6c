"""SLAM orchestration, single-thread mode (port of slam/system.py:
SLAM.__init__ and run_single_thread). Threaded mode, the GUI, prefetch,
checkpoints and multi-device meshes come with later slices of the port."""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from .. import pin_f32_matmul
from ..ops.raster import RasterSettings
from .backend import BackEnd
from .camera import Camera, camera_projection
from .datasets import load_dataset
from .frontend import FrontEnd
from .renderer import activate


class SLAM:
    def __init__(self, config: dict, device="cuda"):
        pin_f32_matmul()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        self.config = config
        self.dataset = load_dataset(config)
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
                               capacity=config.get("capacity", 1 << 17))
        self.frontend = FrontEnd(config, self.settings, self.device)
        self.use_every_n_frames = 1
        self.kf_interval = config["Training"]["kf_interval"]
        self.fps = None
        self.phase_times: dict = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sync_frontend_state(self):
        """Give the frontend the backend's current map + keyframe poses."""
        self.frontend.render_inputs = activate(
            self.backend.params, self.backend.aux.active)
        self.frontend.occ_aware_visibility = dict(self.backend.occ_aware_visibility)
        for idx, cam in self.backend.viewpoints.items():
            if idx in self.frontend.cameras:
                self.frontend.cameras[idx].update_rt(cam.r, cam.t)

    def run_single_thread(self, max_frames: Optional[int] = None):
        t_start = time.time()
        n = len(self.dataset)
        if max_frames is not None:
            n = min(n, max_frames)
        fe, be = self.frontend, self.backend
        cur_window: list = []
        last_kf = 0
        frames_since_kf = 0
        # Wall-clock per phase; each phase ends in a device sync so the
        # time lands on the phase that spent it.
        self.phase_times = {"data": 0.0, "track": 0.0, "map": 0.0,
                            "init": 0.0, "kf_insert": 0.0}

        def tick(phase, t0):
            self._sync()
            now = time.time()
            self.phase_times[phase] += now - t0
            return now

        for idx in range(n):
            t0 = time.time()
            cam = Camera.from_dataset(self.dataset, idx, self.device)
            cam.compute_grad_mask(self.config)
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

            if last_kf in fe.occ_aware_visibility:
                create_kf = frames_since_kf >= self.kf_interval and fe.is_keyframe(
                    idx, last_kf, visibility)
            else:
                create_kf = frames_since_kf >= self.kf_interval
            if len(cur_window) < fe.window_size:
                occ0 = fe.occ_aware_visibility.get(last_kf, visibility)
                union = np.count_nonzero(visibility | occ0)
                intersection = np.count_nonzero(visibility & occ0)
                create_kf = (frames_since_kf >= self.kf_interval
                             and intersection / max(union, 1)
                             < self.config["Training"]["kf_overlap"])
            if not create_kf:
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

        self.fps = n / (time.time() - t_start)
        return self

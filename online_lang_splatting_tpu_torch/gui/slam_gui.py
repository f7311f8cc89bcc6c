"""Interactive open3d SLAM viewer (port of gui/slam_gui.py; the reference's
gui/slam_gui.py:34-777).

A live window fed `GaussianPacket`s over a queue: renders the current map
through the port's renderer either from the SLAM camera or from a
user-navigable free orbit camera (azimuth / elevation / distance sliders and
pan buttons, gui/orbit.py), with a keyframe-frustum wireframe overlay
projected into the panel. Display modes RGB / depth / opacity / language /
ellipsoid, and a pause button that sends `Packet_vis2main(flag_pause)` back
to the SLAM loop, the reference's vis-to-main protocol.

Needs open3d, imported in `SLAM_GUI.__init__` only; without it SLAM falls
back to the HeadlessViewer of viewer.py (set Results.use_gui: "interactive"
on a workstation to use this window). The reference's OpenGL splat shader
is replaced by an open3d point view; the render panel itself uses the
blend kernels.

Standalone entry: `slam_gui.run(params_gui)`, as in the reference.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Optional

import numpy as np

from .orbit import OrbitCamera, draw_frustums
from .viewer import (
    GaussianPacket, _depth_colormap, _lang_pca, _np, gt_thumbnail_strip,
    render_packet,
)


@dataclasses.dataclass
class Packet_vis2main:
    """GUI → SLAM control message (reference gui_utils.py)."""

    flag_pause: bool = False


@dataclasses.dataclass
class ParamsGUI:
    """Wiring for a GUI process/thread (reference params_gui)."""

    q_main2vis: Any = None
    q_vis2main: Any = None
    proj: Any = None
    settings: Any = None


def ellipsoid_geometry(render_inputs, max_points: int = 200_000):
    """Map snapshot → (centers, colors, scales, quats) numpy arrays for the
    ellipsoid display mode (the data the reference's GL shader consumes,
    gl_render/util_gau.py). Needs no open3d."""
    xyz = _np(render_inputs.xyz)
    opa = _np(render_inputs.opacity)
    keep = opa > 0.05
    xyz = xyz[keep][:max_points]
    # SH DC term → RGB (sh_utils.py: 0.5 + C0 * dc).
    shs = _np(render_inputs.shs)[keep][:max_points]
    rgb = np.clip(0.5 + 0.28209479177387814 * shs[:, 0, :], 0, 1)
    scales = _np(render_inputs.scales)[keep][:max_points]
    quats = _np(render_inputs.quats)[keep][:max_points]
    return xyz, rgb, scales, quats


class SLAM_GUI:
    MODES = ("rgb", "depth", "opacity", "language", "ellipsoid")

    def __init__(self, params: ParamsGUI):
        try:
            import open3d as o3d
            import open3d.visualization.gui as gui
            import open3d.visualization.rendering as rendering
        except ImportError as e:  # headless host, or the card's machine
            raise ImportError(
                "SLAM_GUI needs open3d; on headless hosts use the default "
                "HeadlessViewer (Results.use_gui: true)"
            ) from e
        self.o3d, self.gui, self.rendering = o3d, gui, rendering
        self.params = params
        self.packet: Optional[GaussianPacket] = None
        self.mode = "rgb"
        self.paused = False
        self.free_cam = False
        self.show_frustums = True
        self.orbit = OrbitCamera()
        self._build_window()
        self._poll = threading.Thread(target=self._poll_queue, daemon=True)
        self._poll.start()

    # -- window -------------------------------------------------------------

    def _build_window(self):
        gui = self.gui
        self.app = gui.Application.instance
        self.app.initialize()
        self.window = self.app.create_window("OnlineLangSplatting", 1280, 800)
        self.widget = gui.ImageWidget()
        panel = gui.Vert(4)
        self.mode_combo = gui.Combobox()
        for m in self.MODES:
            self.mode_combo.add_item(m)
        self.mode_combo.set_on_selection_changed(self._on_mode)
        self.pause_btn = gui.Button("Pause")
        self.pause_btn.set_on_clicked(self._on_pause)
        panel.add_child(self.mode_combo)
        panel.add_child(self.pause_btn)
        # Free-camera navigation (reference free-view GL camera).
        self.free_cb = gui.Checkbox("Free camera")
        self.free_cb.set_on_checked(self._on_free_cam)
        panel.add_child(self.free_cb)
        self.frustum_cb = gui.Checkbox("Keyframe frustums")
        self.frustum_cb.checked = True
        self.frustum_cb.set_on_checked(self._on_frustums)
        panel.add_child(self.frustum_cb)
        self._sliders = {}
        for name, lo, hi, val in (
            ("azimuth", -180.0, 180.0, 0.0),
            ("elevation", -89.0, 89.0, 0.0),
            ("distance", 0.1, 20.0, 3.0),
        ):
            panel.add_child(gui.Label(name))
            sl = gui.Slider(gui.Slider.DOUBLE)
            sl.set_limits(lo, hi)
            sl.double_value = val
            sl.set_on_value_changed(
                lambda v, n=name: self._on_orbit(n, v)
            )
            self._sliders[name] = sl
            panel.add_child(sl)
        row = gui.Horiz()
        for label, dx, dy in (
            ("←", -0.1, 0.0), ("→", 0.1, 0.0), ("↑", 0.0, -0.1),
            ("↓", 0.0, 0.1),
        ):
            b = gui.Button(label)
            b.set_on_clicked(lambda dx=dx, dy=dy: self._on_pan(dx, dy))
            row.add_child(b)
        panel.add_child(row)
        layout = gui.Horiz()
        layout.add_child(self.widget)
        layout.add_child(panel)
        self.window.add_child(layout)

    def _on_mode(self, text, _idx):
        self.mode = text

    def _on_free_cam(self, checked):
        self.free_cam = bool(checked)
        if checked and self.packet is not None and self.packet.view is not None:
            # Start orbiting from the live camera's target point.
            v = np.linalg.inv(_np(self.packet.view).astype(np.float64))
            self.orbit.target = v[:3, 3] + 2.0 * v[:3, 2]
            self.orbit.radius = 2.0
        self._refresh()

    def _on_frustums(self, checked):
        self.show_frustums = bool(checked)
        self._refresh()

    def _on_orbit(self, name, value):
        if name == "azimuth":
            self.orbit.azimuth = np.deg2rad(value)
        elif name == "elevation":
            self.orbit.elevation = np.deg2rad(value)
        else:
            self.orbit.radius = float(value)
        self._refresh()

    def _on_pan(self, dx, dy):
        self.orbit.pan(dx * self.orbit.radius, dy * self.orbit.radius)
        self._refresh()

    def _on_pause(self):
        # Reference Packet_vis2main round trip (slam_gui.py pause flow).
        self.paused = not self.paused
        self.pause_btn.text = "Resume" if self.paused else "Pause"
        if self.params.q_vis2main is not None:
            self.params.q_vis2main.put(Packet_vis2main(flag_pause=self.paused))

    # -- data ---------------------------------------------------------------

    def _poll_queue(self):
        while True:
            try:
                pkt = self.params.q_main2vis.get(timeout=0.1)
            except queue.Empty:
                continue
            if getattr(pkt, "finish", False):
                self.app.post_to_main_thread(self.window, self.app.quit)
                return
            self.packet = pkt
            self.app.post_to_main_thread(self.window, self._refresh)

    def render_panel(self, pkt: GaussianPacket) -> np.ndarray:
        """(H, W, 3) uint8 panel for the current mode."""
        if self.mode == "ellipsoid":
            xyz, rgb, _s, _q = ellipsoid_geometry(pkt.render_inputs)
            return self._pointcloud_view(xyz, rgb, pkt)
        view = self.orbit.view_matrix() if self.free_cam else _np(pkt.view)
        out = render_packet(pkt, view)
        if self.mode == "depth":
            img = _depth_colormap(_np(out.depth)[0])
        elif self.mode == "opacity":
            img = np.repeat(_np(out.opacity).transpose(1, 2, 0), 3, axis=2)
        elif self.mode == "language" and out.language.shape[0] > 0:
            img = _lang_pca(_np(out.language))
        else:
            img = np.clip(_np(out.color).transpose(1, 2, 0), 0, 1)
        img = np.ascontiguousarray(img, np.float64)
        if self.show_frustums and pkt.keyframe_poses:
            st = pkt.settings
            h, w = st.image_height, st.image_width
            fx = w / (2.0 * st.tanfovx)
            fy = h / (2.0 * st.tanfovy)
            draw_frustums(
                img, view, pkt.keyframe_poses,
                fx=fx, fy=fy, cx=w / 2.0, cy=h / 2.0,
                tanfovx=st.tanfovx, tanfovy=st.tanfovy,
            )
        # Ground-truth side thumbnails (gt colour / depth / language), the
        # reference packets' side panels.
        strip = gt_thumbnail_strip(pkt, img.shape[0])
        if strip is not None:
            img = np.concatenate([img, strip], axis=1)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def _pointcloud_view(self, xyz, rgb, pkt):
        o3d = self.o3d
        pc = o3d.geometry.PointCloud()
        pc.points = o3d.utility.Vector3dVector(xyz.astype(np.float64))
        pc.colors = o3d.utility.Vector3dVector(rgb.astype(np.float64))
        h, w = pkt.settings.image_height, pkt.settings.image_width
        renderer = self.rendering.OffscreenRenderer(w, h)
        renderer.scene.add_geometry(
            "map", pc, self.rendering.MaterialRecord()
        )
        img = renderer.render_to_image()
        return np.asarray(img)

    def _refresh(self):
        if self.packet is None or self.packet.render_inputs is None:
            return
        panel = self.render_panel(self.packet)
        self.widget.update_image(self.o3d.geometry.Image(panel))
        self.window.post_redraw()

    def run(self):
        self.app.run()


def run(params_gui: ParamsGUI):
    """Standalone entry (reference slam_gui.run, :779-784)."""
    gui = SLAM_GUI(params_gui)
    gui.run()

"""Headless live view of a SLAM run (port of gui/viewer.py).

The reference GUI is an open3d window fed GaussianPacket snapshots over a
queue. The headless viewer consumes the same packet stream, renders colour,
depth, opacity and language-PCA panels through the port's renderer (the
blend forward kernel on the card) and writes PNG mosaics instead of
opening a window.

Usage: `HeadlessViewer(out_dir)`, `.submit(packet)` from the SLAM loop
(SLAM does this when Results.use_gui is true), `.close()` at the end.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch


@dataclass
class GaussianPacket:
    """Snapshot handed from the SLAM loop to the viewer (the reference's
    gui/gui_utils.py:77-147). The map's tensors are never written in place
    (models/gaussians.py returns new ones), so no clone is needed."""

    render_inputs: Any = None           # renderer.RenderInputs snapshot
    view: Any = None                    # (4,4) current camera W2C
    proj: Any = None
    settings: Any = None
    gtcolor: Any = None                 # (3, H, W)
    gtdepth: Any = None                 # (H, W)
    gtlanguage: Any = None              # (L, h, w)
    frame_idx: int = 0
    keyframe_window: list = field(default_factory=list)
    keyframe_poses: list = field(default_factory=list)  # (4,4) W2C per KF
    finish: bool = False


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _depth_colormap(depth: np.ndarray) -> np.ndarray:
    d = depth.copy()
    valid = d > 0
    if valid.any():
        lo, hi = np.percentile(d[valid], [2, 98])
        d = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
    rgb = np.stack([d, 1.0 - np.abs(2 * d - 1.0), 1.0 - d], axis=-1)
    rgb[~valid] = 0
    return rgb


def _lang_pca(lang: np.ndarray) -> np.ndarray:
    c, h, w = lang.shape
    flat = lang.reshape(c, -1).T
    flat = flat - flat.mean(axis=0)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:3].T
    lo, hi = np.percentile(proj, 1, axis=0), np.percentile(proj, 99, axis=0)
    return np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1).reshape(h, w, 3)


def _nn_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[ys][:, xs]


def gt_thumbnail_strip(pkt, height: int) -> np.ndarray | None:
    """(height, w, 3) float strip of the packet's ground-truth thumbnails
    (gt colour / depth / language PCA, stacked vertically), the side panels
    of the reference's packets; None when the packet carries no ground
    truth."""
    thumbs = []
    if pkt.gtcolor is not None:
        thumbs.append(np.clip(_np(pkt.gtcolor).transpose(1, 2, 0), 0, 1))
    if pkt.gtdepth is not None:
        thumbs.append(_depth_colormap(_np(pkt.gtdepth)))
    if pkt.gtlanguage is not None:
        thumbs.append(_lang_pca(_np(pkt.gtlanguage)))
    if not thumbs:
        return None
    th = height // len(thumbs)
    tw = max(th * thumbs[0].shape[1] // max(thumbs[0].shape[0], 1), 8)
    strip = np.zeros((height, tw, 3), np.float64)
    for i, t in enumerate(thumbs):
        strip[i * th:(i + 1) * th] = _nn_resize(t.astype(np.float64), th, tw)
    return strip


def render_packet(pkt: GaussianPacket, view=None):
    """The packet's map rendered from `view` (default: the packet's camera)
    on the map's device, without gradients."""
    from ..slam.renderer import render

    xyz = pkt.render_inputs.xyz
    view = pkt.view if view is None else view
    with torch.no_grad():
        return render(pkt.render_inputs,
                      torch.as_tensor(view, dtype=xyz.dtype, device=xyz.device),
                      pkt.proj, pkt.settings)


def mosaic(pkt: GaussianPacket) -> np.ndarray:
    """(H, W', 3) uint8: gt colour, colour, depth, opacity and language-PCA
    panels side by side, then the ground-truth thumbnail strip."""
    out = render_packet(pkt)
    color = np.clip(_np(out.color).transpose(1, 2, 0), 0, 1)
    depth = _depth_colormap(_np(out.depth)[0])
    opac = np.repeat(_np(out.opacity).transpose(1, 2, 0), 3, axis=2)
    panels = [color, depth, opac]
    if out.language.shape[0] > 0:
        panels.append(_lang_pca(_np(out.language)))
    if pkt.gtcolor is not None:
        panels.insert(0, _np(pkt.gtcolor).transpose(1, 2, 0))
    img = np.concatenate(panels, axis=1)
    strip = gt_thumbnail_strip(pkt, img.shape[0])
    if strip is not None:
        img = np.concatenate([img, strip], axis=1)
    return (img * 255).astype(np.uint8)


class HeadlessViewer:
    def __init__(self, out_dir: str, every: int = 10):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.every = every
        self.q: "queue.Queue[GaussianPacket]" = queue.Queue(maxsize=4)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, packet: GaussianPacket):
        try:
            self.q.put_nowait(packet)
        except queue.Full:
            pass  # drop frames under load, like a real-time viewer

    def close(self):
        self.q.put(GaussianPacket(finish=True))
        self._thread.join(timeout=30)

    def _run(self):
        from PIL import Image

        while True:
            pkt = self.q.get()
            if pkt.finish:
                return
            if pkt.frame_idx % self.every or pkt.render_inputs is None:
                continue
            try:
                Image.fromarray(mosaic(pkt)).save(
                    self.out_dir / f"frame_{pkt.frame_idx:05d}.png")
            except Exception as e:  # the viewer never stops the SLAM loop
                print(f"[viewer] {type(e).__name__}: {e}")

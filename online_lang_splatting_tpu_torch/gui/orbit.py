"""Free-camera orbit navigation and the keyframe-frustum overlay (port of
gui/orbit.py; numpy only).

The reference GUI renders the map from a user-navigable camera with
keyframe frustum line sets (its gui/slam_gui.py:233-320) in an
OpenGL viewport. Here the camera math and the overlay geometry stay on the
host: `OrbitCamera` gives a W2C matrix the blend kernels render from, and
`draw_frustums` projects the keyframe frustum wireframes straight into the
rendered panel. Nothing here needs a display.
"""

from __future__ import annotations

import numpy as np

# Frustum wireframe edges over the 5 canonical points
# (apex + 4 image-plane corners), like the reference line sets.
FRUSTUM_LINES = np.array(
    [[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]],
    np.int32,
)


class OrbitCamera:
    """Azimuth/elevation/radius orbit around a target point.

    `view_matrix()` returns a (4, 4) W2C matrix (y-down, z-forward camera
    like the SLAM cameras). rotate/zoom/pan mutate the state; all angles in
    radians.
    """

    def __init__(self, target=(0.0, 0.0, 3.0), radius: float = 3.0,
                 azimuth: float = 0.0, elevation: float = 0.0):
        self.target = np.asarray(target, np.float64).copy()
        self.radius = float(radius)
        self.azimuth = float(azimuth)
        self.elevation = float(elevation)

    def rotate(self, d_azimuth: float, d_elevation: float):
        self.azimuth = (self.azimuth + d_azimuth) % (2 * np.pi)
        lim = np.pi / 2 - 1e-3
        self.elevation = float(
            np.clip(self.elevation + d_elevation, -lim, lim)
        )

    def zoom(self, factor: float):
        self.radius = float(np.clip(self.radius * factor, 1e-3, 1e6))

    def pan(self, dx: float, dy: float):
        """Shift the target in the camera's right/up plane."""
        c2w = np.linalg.inv(self.view_matrix())
        right, up = c2w[:3, 0], c2w[:3, 1]
        self.target = self.target + dx * right + dy * up

    def eye(self) -> np.ndarray:
        ce, se = np.cos(self.elevation), np.sin(self.elevation)
        ca, sa = np.cos(self.azimuth), np.sin(self.azimuth)
        # Camera orbits the target; azimuth 0 / elevation 0 looks down +z
        # from in front of the target (matching the SLAM convention where
        # the scene sits at positive z in camera frame).
        offset = np.array([sa * ce, -se, -ca * ce])
        return self.target + self.radius * offset

    def view_matrix(self) -> np.ndarray:
        eye = self.eye()
        fwd = self.target - eye
        fwd = fwd / np.linalg.norm(fwd)
        world_up = np.array([0.0, -1.0, 0.0])  # y-down camera convention
        right = np.cross(world_up, fwd)
        n = np.linalg.norm(right)
        if n < 1e-6:  # looking straight along up
            right = np.array([1.0, 0.0, 0.0])
        else:
            right = right / n
        up = np.cross(fwd, right)
        w2c = np.eye(4)
        w2c[0, :3], w2c[1, :3], w2c[2, :3] = right, up, fwd
        w2c[:3, 3] = -w2c[:3, :3] @ eye
        return w2c.astype(np.float32)


def frustum_points(kf_w2c: np.ndarray, tanfovx: float, tanfovy: float,
                   scale: float = 0.1) -> np.ndarray:
    """World-space frustum wireframe points (5, 3) for one keyframe:
    camera center + 4 image-plane corners at depth `scale` (the reference's
    per-keyframe frustum line sets, gui/slam_gui.py:233-320)."""
    c2w = np.linalg.inv(np.asarray(kf_w2c, np.float64))
    corners_cam = np.array([
        [0.0, 0.0, 0.0],
        [-tanfovx, -tanfovy, 1.0],
        [tanfovx, -tanfovy, 1.0],
        [tanfovx, tanfovy, 1.0],
        [-tanfovx, tanfovy, 1.0],
    ]) * scale
    corners_cam[:, 2] = np.array([0.0, scale, scale, scale, scale])
    pts = corners_cam @ c2w[:3, :3].T + c2w[:3, 3]
    return pts


def _draw_line(img: np.ndarray, p0, p1, color):
    """Clip-and-draw one 2D segment into an (H, W, 3) float image."""
    h, w = img.shape[:2]
    x0, y0 = p0
    x1, y1 = p1
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    xi = np.round(xs).astype(int)
    yi = np.round(ys).astype(int)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    img[yi[ok], xi[ok]] = color


def draw_frustums(
    img: np.ndarray,
    view_w2c: np.ndarray,
    kf_poses,
    *,
    fx: float, fy: float, cx: float, cy: float,
    tanfovx: float, tanfovy: float,
    scale: float = 0.1,
    color=(1.0, 0.2, 0.1),
    current_color=(0.1, 0.4, 1.0),
) -> np.ndarray:
    """Overlay keyframe frustum wireframes onto a rendered (H, W, 3) float
    panel, projecting through the viewer camera `view_w2c`. The LAST pose
    in `kf_poses` is drawn in `current_color` (the reference highlights
    the live camera). Returns the image (mutated in place)."""
    view = np.asarray(view_w2c, np.float64)
    colors = [color] * len(kf_poses)
    if colors:
        colors[-1] = current_color
    for kf, col in zip(kf_poses, colors):
        pts_w = frustum_points(kf, tanfovx, tanfovy, scale)
        pts_c = pts_w @ view[:3, :3].T + view[:3, 3]
        for a, b in FRUSTUM_LINES:
            pa, pb = pts_c[a], pts_c[b]
            if pa[2] <= 1e-4 or pb[2] <= 1e-4:
                continue  # behind the viewer camera
            ax = fx * pa[0] / pa[2] + cx
            ay = fy * pa[1] / pa[2] + cy
            bx = fx * pb[0] / pb[2] + cx
            by = fy * pb[1] / pb[2] + cy
            _draw_line(img, (ax, ay), (bx, by), np.asarray(col))
    return img

"""Polygon filling without OpenCV, pixel-exact against `cv2.fillPoly`.

`fill_poly` follows OpenCV's rule for integer vertices (shift 0, 8-connected
lines): every edge is first drawn as an 8-connected Bresenham line, clipped
to the image as `cv2.clipLine` clips it, and the non-horizontal edges are
then filled scanline by scanline in 16.16 fixed point, each span running
between a pair of active edges in x order (OpenCV 5's rule; the tests hold
it against the installed `cv2.fillPoly`). Edges are therefore part of the
mask, and vertices outside the image are clipped, not dropped.

`polygons_to_mask` rasterises labelme polygons as the LERF evaluation and
the Replica label tools read them.
"""

from __future__ import annotations

import numpy as np

_SHIFT = 16
_ONE = 1 << _SHIFT


def _trunc_div(a: int, b: int) -> int:
    """C integer division: the quotient rounded towards zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """`cv2.clipLine` on the image rectangle: the clipped end points and
    whether any part of the segment lies inside."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return x1, y1, x2, y2, (c1 | c2) == 0


def line_pixels(w: int, h: int, x0: int, y0: int, x1: int, y1: int):
    """(xs, ys) of the 8-connected line `cv2.line` draws from (x0, y0) to
    (x1, y1) in a w x h image (clipped first, then walked left to right)."""
    if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
        x0, y0, x1, y1, inside = _clip_line(w, h, x0, y0, x1, y1)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    # Bresenham with OpenCV's error term: the minor coordinate after i
    # major steps is ceil((2 minor i - major) / (2 major)).
    if dy > dx:
        i = np.arange(dy + 1, dtype=np.int64)
        return x0 - (-(2 * dx * i - dy) // (2 * dy)), y0 + sy * i
    i = np.arange(dx + 1, dtype=np.int64)
    if dx == 0:
        return np.array([x0], np.int64), np.array([y0], np.int64)
    return x0 + i, y0 + sy * (-(-(2 * dy * i - dx) // (2 * dx)))


def fill_poly(img: np.ndarray, polygons, value=1) -> np.ndarray:
    """Fill `polygons` (a list of (N, 2) integer x, y vertex arrays) into
    `img` (H, W) in place, as `cv2.fillPoly(img, polygons, value)` with the
    default 8-connected line type and shift 0; returns `img`."""
    h, w = img.shape[:2]
    edges = []  # (y0, y1, x at y0 in 16.16, dx per row)
    for poly in polygons:
        pts = np.asarray(poly, np.int64).reshape(-1, 2)
        n = len(pts)
        for k in range(n):
            (ax, ay), (bx, by) = pts[k - 1], pts[k]
            ax, ay, bx, by = int(ax), int(ay), int(bx), int(by)
            xs, ys = line_pixels(w, h, ax, ay, bx, by)
            img[ys, xs] = value
            # The edge for the scanline fill. Where a vertex lies outside,
            # OpenCV takes x from the clipped end points, and y too unless
            # the clipped segment is horizontal.
            p0x, p0y, p1x, p1y = ax << _SHIFT, ay, bx << _SHIFT, by
            if not (0 <= ax < w and 0 <= bx < w and 0 <= ay < h and 0 <= by < h):
                cx0, cy0, cx1, cy1, _ = _clip_line(w, h, ax, ay, bx, by)
                if cy0 != cy1:
                    p0y, p1y = cy0, cy1
                p0x, p1x = cx0 << _SHIFT, cx1 << _SHIFT
            if ay == by:
                continue
            dx = _trunc_div(p1x - p0x, p1y - p0y)
            if ay < by:
                edges.append((ay, by, p0x + (ay - p0y) * dx, dx))
            else:
                edges.append((by, ay, p1x + (by - p1y) * dx, dx))
    if len(edges) < 2:
        return img
    e = np.array(edges, np.int64)
    y0, y1, x0, dx = e.T
    x_end = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), x_end.max()) < 0
            or min(x0.min(), x_end.min()) >= (w << _SHIFT)):
        return img
    for y in range(max(int(y0.min()), 0), min(int(y1.max()), h)):
        live = (y0 <= y) & (y < y1)
        if live.sum() < 2:
            continue
        xs = np.sort(x0[live] + (y - y0[live]) * dx[live])
        pairs = xs[: len(xs) // 2 * 2].reshape(-1, 2)
        # A span runs from the ceiling of its left x to the floor of its right.
        for a, b in zip((pairs[:, 0] + _ONE - 1) >> _SHIFT, pairs[:, 1] >> _SHIFT):
            if a < w and b >= 0:
                img[y, max(a, 0): min(b, w - 1) + 1] = value
    return img


def polygons_to_mask(shape, points_list) -> np.ndarray:
    """Labelme polygons (each a list of [x, y]) -> (H, W) uint8 mask, each
    polygon filled on its own as `cv2.fillPoly(mask, [pts], 1)`."""
    mask = np.zeros(shape, np.uint8)
    for pts in points_list:
        fill_poly(mask, [np.asarray(pts, np.int32)], 1)
    return mask

"""Connected components and outer contours of binary masks without OpenCV,
equal to what `cv2.connectedComponents` and `cv2.findContours(RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE)` return, for the Replica label tools.

* `connected_components`: 8-connected labels numbered as OpenCV's default
  block-based labelling numbers them, by each component's first 2x2 block
  in raster order of blocks (scipy.ndimage labels, renumbered).
* `find_external_contours`: Suzuki-Abe border following as OpenCV's
  legacy scanner runs it on a one-pixel zero-padded copy: the raster scan
  with its last-border bookkeeping (an outer border starts where a 0 is
  followed by a 1, and in external mode only where the last marked border
  pixel to its left is not a left border), each border walked with
  OpenCV's direction codes and marks, and only the points where the chain
  code changes kept. Contours come last-found first, as OpenCV lists them.
* `contour_area` (shoelace, unsigned) and `bounding_rect`.
"""

from __future__ import annotations

import numpy as np

# OpenCV's chain codes: 0 = +x, then counter-clockwise on screen (y down).
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_MARK, _RIGHT_MARK = 2, 2 - 128  # nbd and nbd | -128 as signed chars


def connected_components(mask: np.ndarray):
    """(number of labels including background 0, (H, W) int32 labels) of
    the mask's 8-connected foreground."""
    from scipy import ndimage

    lab, n = ndimage.label(np.asarray(mask) != 0, structure=np.ones((3, 3), bool))
    if n == 0:
        return 1, lab.astype(np.int32)
    ys, xs = np.nonzero(lab)
    w_blocks = (lab.shape[1] + 1) // 2
    key = (ys // 2) * w_blocks + xs // 2
    first = np.full(n + 1, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first, lab[ys, xs], key)
    order = np.argsort(first[1:], kind="stable")
    remap = np.zeros(n + 1, np.int32)
    remap[order + 1] = np.arange(1, n + 1, dtype=np.int32)
    return n + 1, remap[lab]


def _follow(flat: np.ndarray, step: int, i0: int) -> list:
    """Walk the outer border starting at flat index i0 (OpenCV's
    icvFetchContour with CHAIN_APPROX_SIMPLE), marking it in `flat`;
    returns the kept points in padded coordinates."""
    deltas = [dx + dy * step for dx, dy in zip(_DX, _DY)] * 2
    x, y = i0 % step, i0 // step
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if flat[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        flat[i0] = _RIGHT_MARK
        return [(x, y)]
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if flat[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:
            flat[i3] = _RIGHT_MARK
        elif flat[i3] == 1:
            flat[i3] = _MARK
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += _DX[s]
        y += _DY[s]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def find_external_contours(mask: np.ndarray) -> list:
    """Outer contours of the mask's nonzero pixels as (N, 2) int32 (x, y)
    arrays, as `cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`
    gives them (each squeezed to (N, 2))."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = np.asarray(mask) != 0
    flat = img.reshape(-1)
    step = w + 2
    found = []
    for y in range(1, h + 1):
        row = img[y]
        x, prev, lnbd_x = 1, 0, 0
        while x < step - 1:
            change = np.flatnonzero(row[x:step - 1] != prev)
            if not len(change):
                break
            x += int(change[0])
            p = int(row[x])
            outer = prev == 0 and p == 1
            if not outer and p == 0 and prev >= 1 and prev & -2:
                lnbd_x = x - 1  # a hole's start; holes are not followed here
            if outer and row[lnbd_x] <= 0:
                pts = _follow(flat, step, y * step + x)
                found.append(np.asarray(pts, np.int32) - 1)
                lnbd_x = x
                prev = int(row[x])
                x += 1
                continue
            prev = p
            if prev & -2:
                lnbd_x = x
            x += 1
    return found[::-1]


def contour_area(pts: np.ndarray) -> float:
    """Unsigned shoelace area of a closed (N, 2) point chain
    (`cv2.contourArea`)."""
    p = np.asarray(pts, np.int64).reshape(-1, 2)
    q = np.roll(p, 1, axis=0)
    return abs(float(np.sum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]))) * 0.5


def bounding_rect(pts: np.ndarray):
    """(x, y, w, h) of the points (`cv2.boundingRect`)."""
    p = np.asarray(pts).reshape(-1, 2)
    x0, y0 = p.min(0)
    x1, y1 = p.max(0)
    return int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)

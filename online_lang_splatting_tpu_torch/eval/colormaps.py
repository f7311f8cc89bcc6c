"""Visualisation colormaps of the evaluation tools (port of
eval/colormaps.py): PCA feature colourisation with median-absolute-
deviation outlier rejection, scalar colormaps with normalize / range /
invert options, boolean masks, and PNG saving.

The maps stay numpy: they are host visualisation, and a device SVD may
flip a component's sign and so invert a colour channel. PNGs are written
by the port's zlib writer (utils/png.py) with the pixels `cv2.imwrite`
writes for the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ColormapOptions:
    """Mirror of the reference options (colormaps.py:17-28)."""

    colormap: str = "turbo"
    normalize: bool = False
    colormap_min: float = 0.0
    colormap_max: float = 1.0
    invert: bool = False


# Matplotlib-free turbo colormap: 16-point LUT of Google's turbo spline,
# linearly interpolated — enough fidelity for heatmap visualization.
_TURBO = np.array([
    [0.190, 0.072, 0.232], [0.276, 0.274, 0.662], [0.275, 0.439, 0.899],
    [0.212, 0.609, 0.997], [0.100, 0.760, 0.877], [0.085, 0.869, 0.689],
    [0.248, 0.945, 0.444], [0.504, 0.990, 0.230], [0.714, 0.986, 0.177],
    [0.874, 0.918, 0.220], [0.970, 0.796, 0.231], [0.998, 0.631, 0.172],
    [0.963, 0.434, 0.087], [0.868, 0.265, 0.031], [0.715, 0.130, 0.008],
    [0.480, 0.016, 0.011],
], np.float32)


def apply_float_colormap(image: np.ndarray, colormap: str = "turbo") -> np.ndarray:
    """(…, 1) or (…,) floats in [0,1] → (…, 3) RGB."""
    x = np.clip(np.squeeze(image, -1) if image.shape[-1] == 1 else image, 0, 1)
    if colormap == "gray":
        return np.repeat(x[..., None], 3, axis=-1)
    pos = x * (len(_TURBO) - 1)
    lo = np.floor(pos).astype(np.int32)
    hi = np.minimum(lo + 1, len(_TURBO) - 1)
    frac = (pos - lo)[..., None]
    return _TURBO[lo] * (1 - frac) + _TURBO[hi] * frac


def apply_colormap(
    image: np.ndarray,
    colormap_options: ColormapOptions = ColormapOptions(),
    eps: float = 1e-9,
) -> np.ndarray:
    """Scalar map → RGB with the reference's normalize/range handling
    (colormaps.py:30-66)."""
    x = np.asarray(image, np.float32)
    if x.ndim >= 3 and x.shape[-1] == 3:
        return x
    if x.ndim >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    if colormap_options.normalize:
        x = x - x.min()
        x = x / (x.max() + eps)
    x = (
        x * (colormap_options.colormap_max - colormap_options.colormap_min)
        + colormap_options.colormap_min
    )
    x = np.clip(x, 0, 1)
    if colormap_options.invert:
        x = 1.0 - x
    return apply_float_colormap(x, colormap_options.colormap)


def apply_boolean_colormap(
    mask: np.ndarray,
    true_color=(1.0, 1.0, 1.0),
    false_color=(0.0, 0.0, 0.0),
) -> np.ndarray:
    out = np.empty(mask.shape[:2] + (3,), np.float32)
    out[mask.astype(bool)] = true_color
    out[~mask.astype(bool)] = false_color
    return out


def apply_pca_colormap(image: np.ndarray, m: float = 3.0) -> np.ndarray:
    """(…, C) feature image → (…, 3) RGB via PCA with per-channel
    median-absolute-deviation outlier rejection — the reference
    apply_pca_colormap (colormaps.py:176-215), numpy."""
    shape = image.shape
    flat = image.reshape(-1, shape[-1]).astype(np.float64)
    centered = flat - flat.mean(axis=0)
    # torch.pca_lowrank equivalent: right singular vectors of centered data.
    sample = centered[:: max(len(centered) // 20000, 1)]
    _, _, vt = np.linalg.svd(sample, full_matrices=False)
    proj = flat @ vt[:3].T
    d = np.abs(proj - np.median(proj, axis=0))
    mdev = np.median(d, axis=0)
    s = d / np.maximum(mdev, 1e-12)
    cols = []
    for c in range(3):
        ins = proj[s[:, c] < m, c]
        if len(ins) == 0:
            return np.zeros(shape[:-1] + (3,), np.float32)
        lo, hi = ins.min(), ins.max()
        cols.append(np.clip((proj[:, c] - lo) / max(hi - lo, 1e-12), 0, 1))
    return np.stack(cols, -1).astype(np.float32).reshape(shape[:-1] + (3,))


def colormap_saving(image: np.ndarray, colormap_options: ColormapOptions,
                    save_path=None) -> np.ndarray:
    """Apply + optionally save as an 8-bit RGB PNG (reference
    eval/utils.py:59-75)."""
    rgb = apply_colormap(image, colormap_options)
    if save_path is not None:
        from ..utils.png import write_png

        write_png(save_path, (rgb * 255).astype(np.uint8))
    return rgb


def vis_mask_save(mask: np.ndarray, save_path=None) -> np.ndarray:
    """Save a boolean mask as an 8-bit grey PNG (reference
    eval/utils.py:76-82)."""
    img = (mask.astype(np.float32) * 255).astype(np.uint8)
    if save_path is not None:
        from ..utils.png import write_png

        write_png(save_path, img)
    return img

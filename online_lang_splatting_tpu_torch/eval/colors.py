"""Named colour constants for the evaluation visualisations (port of
eval/colors.py, numpy, copied): a nerfstudio-style palette as float32
arrays in [0, 1]."""

from __future__ import annotations

import numpy as np

WHITE = np.array([1.0, 1.0, 1.0], np.float32)
BLACK = np.array([0.0, 0.0, 0.0], np.float32)
RED = np.array([1.0, 0.0, 0.0], np.float32)
GREEN = np.array([0.0, 1.0, 0.0], np.float32)
BLUE = np.array([0.0, 0.0, 1.0], np.float32)

COLORS_DICT = {
    "aliceblue": np.array([0.941, 0.973, 1.000], np.float32),
    "antiquewhite": np.array([0.980, 0.922, 0.843], np.float32),
    "aqua": np.array([0.000, 1.000, 1.000], np.float32),
    "azure": np.array([0.941, 1.000, 1.000], np.float32),
    "beige": np.array([0.961, 0.961, 0.863], np.float32),
    "chartreuse": np.array([0.498, 1.000, 0.000], np.float32),
    "coral": np.array([1.000, 0.498, 0.314], np.float32),
    "crimson": np.array([0.863, 0.078, 0.235], np.float32),
    "cyan": np.array([0.000, 1.000, 1.000], np.float32),
    "fuchsia": np.array([1.000, 0.000, 1.000], np.float32),
    "gold": np.array([1.000, 0.843, 0.000], np.float32),
    "indigo": np.array([0.294, 0.000, 0.510], np.float32),
    "lime": np.array([0.000, 1.000, 0.000], np.float32),
    "magenta": np.array([1.000, 0.000, 1.000], np.float32),
    "orange": np.array([1.000, 0.647, 0.000], np.float32),
    "orchid": np.array([0.855, 0.439, 0.839], np.float32),
    "pink": np.array([1.000, 0.753, 0.796], np.float32),
    "purple": np.array([0.502, 0.000, 0.502], np.float32),
    "red": RED, "green": GREEN, "blue": BLUE,
    "salmon": np.array([0.980, 0.502, 0.447], np.float32),
    "teal": np.array([0.000, 0.502, 0.502], np.float32),
    "turquoise": np.array([0.251, 0.878, 0.816], np.float32),
    "violet": np.array([0.933, 0.510, 0.933], np.float32),
    "yellow": np.array([1.000, 1.000, 0.000], np.float32),
    "white": WHITE, "black": BLACK,
}


def get_color(color) -> np.ndarray:
    """Name or [r, g, b] list → (3,) float array (reference colors.py:37)."""
    if isinstance(color, str):
        name = color.lower()
        if name not in COLORS_DICT:
            raise ValueError(f"{color} is not a valid color name")
        return COLORS_DICT[name]
    color = np.asarray(color, np.float32)
    if color.shape != (3,) or color.max() > 1.0 or color.min() < 0.0:
        raise ValueError("color must be 3 floats in [0, 1]")
    return color

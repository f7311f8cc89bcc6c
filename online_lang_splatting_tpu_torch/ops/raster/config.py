"""Blend-loop constants of the splatting pipeline (ops/raster/config.py:41-53
of the JAX package). No environment knobs: the port follows the default
path only."""

NUM_COLOR_CHANNELS = 3
DEFAULT_LANGUAGE_CHANNELS = 15
DEFAULT_TILE = 16

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
NEAR_CLIP = 0.2
LOWPASS = 0.3
N_TOUCHED_T = 0.5

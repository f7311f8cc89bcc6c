"""PyTorch/CUDA port of Online Language Splatting.

Mirrors the layout of the JAX package `online_lang_splatting_tpu`, which
stays the reference: every module here keeps the JAX package's array
layouts at its public functions (images (C, H, W), Gaussian parameters as
fixed-capacity SoA rows with an active mask, poses as W2C (4, 4)). The
blend kernels are hand-written CUDA for Hopper (`csrc/`); everything
around them is plain PyTorch.

This package imports torch and never jax.
"""

import torch


def pin_f32_matmul() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    The JAX reference pins geometry to "highest" precision (ops/raster/
    api.py); TF32 shifts projected points by ~0.1 px. Called by every
    entry point of the port.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def entry_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on, after `pin_f32_matmul`. A CUDA
    device that is not there raises: no entry point falls back to the CPU
    unless asked for it."""
    pin_f32_matmul()
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name} requested but CUDA is not available")
    return device

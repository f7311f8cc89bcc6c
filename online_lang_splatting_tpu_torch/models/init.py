"""Random initialization with the scales of the JAX package's flax
initializers, so random-weight runs of the port see activations of the
same size as the JAX package's: lecun-normal kernels (truncated normal,
fan-in scaling), zero biases, LayerNorm / BatchNorm scale 1 and bias 0,
BatchNorm running mean 0 and variance 1. Draws come from an explicit
`torch.Generator`; the values differ from flax's, the scales do not."""

from __future__ import annotations

import torch
from torch import nn

# Standard deviation of a unit normal truncated to [-2, 2] (flax's
# variance_scaling divides by it).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> torch.Tensor:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator | None) -> nn.Module:
    """Re-initialize every Conv2d / ConvTranspose2d / Linear of `module`
    like flax does. The fan-in of all three is `weight[0].numel()`: in
    channels x kernel area for a convolution (per group), out channels x
    kernel area for a transposed one (flax's `transpose_kernel` layout puts
    the output features on the fan-in axis), in features for a Linear."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
            m.reset_parameters()
    return module


def make_generator(seed: int) -> torch.Generator:
    """A CPU generator: weights are drawn on the host and moved, so a seed
    gives the same weights whatever the device."""
    return torch.Generator().manual_seed(int(seed))

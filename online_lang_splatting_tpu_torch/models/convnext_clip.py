"""ConvNeXt-L CLIP visual tower with dense pyramid output (port of
models/convnext_clip.py).

The stem, four ConvNeXt stages and the CLIP projection head applied per
spatial location of the os32 map, as the reference's open_clip TimmModel
dense forward computes them. Only the reference-exact forms are ported:
erf GELU, the 4x4/stride-4 convolution stem and the per-location Linear
head (the JAX package's tanh GELU, space-to-depth stem and flat head are
TPU lowering choices).

Module names follow open_clip's `visual.*` state_dict without the
`visual.` prefix (`trunk.stem.0.weight`, `trunk.stages.2.blocks.26.gamma`,
`head.mlp.fc1.weight`, ...), so a converted reference checkpoint loads
with `load_state_dict`. Activations are NCHW in channels_last memory, so
the per-block NCHW <-> NHWC permutes around the LayerNorm and MLP are
views, not copies.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .init import flax_init_

DEPTHS = (3, 3, 27, 3)
DIMS = (192, 384, 768, 1536)
EMBED_DIM = 768

# SED/CLIP preprocessing constants (RGB order, 0-255 inputs).
CLIP_PIXEL_MEAN = (122.7709383, 116.7460125, 104.09373615)
CLIP_PIXEL_STD = (68.5005327, 66.6321579, 70.3231630)

LN_EPS = 1e-6


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map."""

    def forward(self, x):
        y = F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int | None = None,
                 bias_out: bool = True):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim, bias=bias_out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, 4 * dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.conv_dw(x).permute(0, 2, 3, 1)
        y = self.gamma * self.mlp(self.norm(y))
        return x + y.permute(0, 3, 1, 2)


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, downsample: bool):
        super().__init__()
        self.downsample = (
            nn.Sequential(LayerNorm2d(in_dim, eps=LN_EPS),
                          nn.Conv2d(in_dim, dim, 2, stride=2))
            if downsample else nn.Identity())
        self.blocks = nn.Sequential(*(ConvNeXtBlock(dim) for _ in range(depth)))

    def forward(self, x):
        return self.blocks(self.downsample(x))


class _TrunkHead(nn.Module):
    """timm's classifier head; only its LayerNorm is used (per location)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


class ConvNeXtTrunk(nn.Module):
    def __init__(self, depths: Sequence[int], dims: Sequence[int]):
        super().__init__()
        self.stem = nn.Sequential(nn.Conv2d(3, dims[0], 4, stride=4),
                                  LayerNorm2d(dims[0], eps=LN_EPS))
        self.stages = nn.Sequential(*(
            ConvNeXtStage(dims[max(i - 1, 0)], dims[i], depths[i], i > 0)
            for i in range(len(depths))))
        self.head = _TrunkHead(dims[-1])


class _ProjHead(nn.Module):
    def __init__(self, dim: int, embed_dim: int):
        super().__init__()
        self.mlp = Mlp(dim, 2 * embed_dim, embed_dim, bias_out=False)


class ConvNeXtCLIPVisual(nn.Module):
    """Dense visual tower. Input (N, 3, H, W), already normalized. Returns
    NCHW maps: stem (os4), res2 (os4), res3 (os8), res4 (os16), res5 (os32)
    and clip_vis_dense (os32, `embed_dim` channels)."""

    def __init__(self, depths: Sequence[int] = DEPTHS,
                 dims: Sequence[int] = DIMS, embed_dim: int = EMBED_DIM,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trunk = ConvNeXtTrunk(depths, dims)
        self.head = _ProjHead(dims[-1], embed_dim)
        flax_init_(self, generator)

    def forward(self, x):
        return promote_call(self, self.trunk.stem[0].weight.dtype, self._forward, x)

    def _forward(self, x):
        out = {}
        x = self.trunk.stem(x.contiguous(memory_format=torch.channels_last))
        out["stem"] = x
        for i, stage in enumerate(self.trunk.stages):
            x = stage(x)
            out[f"res{i + 2}"] = x
        y = self.trunk.head.norm(x.permute(0, 2, 3, 1))
        out["clip_vis_dense"] = self.head.mlp(y).permute(0, 3, 1, 2)
        return out


def promote_call(module: nn.Module, weight_dtype: torch.dtype, body, *xs):
    """`body(*xs)` under flax's promote_dtype rule at a module's entry:
    inputs and weights meet at their promoted dtype. A bfloat16 input into
    float32 weights computes in float32, not a downcast; a float32 input
    into bfloat16 weights computes in float32 with the weights upcast for
    this call (`torch.func.functional_call`)."""
    dt = functools.reduce(torch.promote_types, [x.dtype for x in xs], weight_dtype)
    xs = tuple(x.to(dt) for x in xs)
    if dt == weight_dtype:
        return body(*xs)
    state = {k: v.to(dt) if v.is_floating_point() else v
             for k, v in module.state_dict(keep_vars=True).items()}
    return torch.func.functional_call(module, state, xs)


def normalize_image(rgb_0_255: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 255] -> CLIP-normalized (SED convention)."""
    mean = torch.tensor(CLIP_PIXEL_MEAN, dtype=rgb_0_255.dtype, device=rgb_0_255.device)
    std = torch.tensor(CLIP_PIXEL_STD, dtype=rgb_0_255.dtype, device=rgb_0_255.device)
    return (rgb_0_255 - mean) / std


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW bilinear resize, F.interpolate(align_corners=False,
    antialias=False) as the reference calls it, also on downscale."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)

"""High-resolution language feature head (port of models/hr_net.py).

768 -> 512 3x3 conv, three ConvTranspose x2 upsamplings (24 -> 48 -> 96 ->
192), two AttentionFusion blocks that inject the ConvNeXt res3 and res2
skips with sigmoid attention and a residual, and a final 1x1 conv back to
768 channels. BatchNorm runs with its stored running statistics (eval
mode, eps 1e-5). Module names follow the reference checkpoint's
`model.*` keys without the Lightning `model.` prefix (`initial_conv.0`,
`upsample1.0`, `attention_fusion1.low_res_align`, `final_conv`, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .convnext_clip import promote_call, resize_bilinear
from .init import flax_init_


class PhaseConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d(k=4, s=2, p=1), the same parameters, computed as four
    2x2 convolutions (one per output phase) and interleaved: the JAX
    package's PhaseConvTranspose2x. cuDNN runs a transposed convolution as
    its backward-data pass, whose algorithms may sum with atomics, so the
    map differed in its last bits from run to run on the card; forward
    convolutions sum in a fixed order. cuDNN's transposed convolution with
    `cudnn.deterministic` set for the call repeats too, but the flag is
    process-wide and the whole head is slower that way on an H100
    (tools/upsample_ab.py).

    out[2y + r, 2x + s] = sum over taps in[iy, ix] w[ky, kx] with
    ky = 2y + r - 2 iy + 1: phase r = 0 takes input rows (y - 1, y) with
    kernel rows (3, 1), phase r = 1 rows (y, y + 1) with kernel rows (2, 0);
    columns likewise."""

    _TAPS = {0: ((3, 1), (1, 0)), 1: ((2, 0), (0, 1))}  # kernel taps, padding

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 4, stride=2, padding=1)

    def forward(self, x):
        phases = []
        for r in (0, 1):
            (ky, pad_y) = self._TAPS[r]
            row = []
            for s in (0, 1):
                (kx, pad_x) = self._TAPS[s]
                # Each list index is uploaded, which waits for the device.
                with span("sync.extract.upsample"):
                    k = self.weight[:, :, list(ky)]
                with span("sync.extract.upsample"):
                    k = k[:, :, :, list(kx)].transpose(0, 1)
                row.append(F.conv2d(F.pad(x, (*pad_x, *pad_y)), k, self.bias))
            phases.append(torch.stack(row, -1))  # (N, C, H, W, 2)
        n, c, h, w, _ = phases[0].shape
        return torch.stack(phases, 3).reshape(n, c, 2 * h, 2 * w)


class ConvBNRelu(nn.Sequential):
    """conv (3x3, or ConvTranspose2d(k=4, s=2, p=1) = a 2x upsample) ->
    BatchNorm2d -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 transpose: bool = False):
        conv = (PhaseConvTranspose2d(cin, cout) if transpose
                else nn.Conv2d(cin, cout, kernel, padding=kernel // 2))
        super().__init__(conv, nn.BatchNorm2d(cout, eps=1e-5), nn.ReLU())


class AttentionFusion(nn.Module):
    def __init__(self, channels: int, low_channels: int):
        super().__init__()
        self.low_res_align = (nn.Conv2d(low_channels, channels, 1)
                              if low_channels != channels else nn.Identity())
        self.fusion = ConvBNRelu(2 * channels, channels)
        self.attention = nn.Sequential(
            nn.Conv2d(channels, channels, 3, padding=1),
            nn.BatchNorm2d(channels, eps=1e-5), nn.ReLU(),
            nn.Conv2d(channels, channels, 1), nn.Sigmoid())

    def forward(self, high, low):
        fused = self.fusion(torch.cat([high, self.low_res_align(low)], dim=1))
        return fused * self.attention(fused) + fused


class HighResLanguageFeatureNet(nn.Module):
    """fv (N, in, 24, 24) dense CLIP map, res3 (N, res3, 96, 96), res2
    (N, res2, 192, 192) ConvNeXt skips -> (N, out, 192, 192)."""

    def __init__(self, in_channels: int = 768, res3_channels: int = 384,
                 res2_channels: int = 192, out_channels: int = 768,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.initial_conv = ConvBNRelu(in_channels, 512)
        self.upsample1 = ConvBNRelu(512, 512, transpose=True)
        self.attention_fusion1 = AttentionFusion(512, res3_channels)
        self.upsample2 = ConvBNRelu(512, 256, transpose=True)
        self.attention_fusion2 = AttentionFusion(256, res2_channels)
        self.upsample3 = ConvBNRelu(256, 128, transpose=True)
        self.final_conv = nn.Conv2d(128, out_channels, 1)
        flax_init_(self, generator)

    def forward(self, fv, res3, res2):
        return promote_call(self, self.final_conv.weight.dtype, self._forward, fv, res3, res2)

    def _forward(self, fv, res3, res2):
        x = self.upsample1(self.initial_conv(fv))
        x = self.attention_fusion1(x, resize_bilinear(res3, x.shape[-2:]))
        x = self.upsample2(x)
        x = self.attention_fusion2(x, resize_bilinear(res2, x.shape[-2:]))
        return self.final_conv(self.upsample3(x))

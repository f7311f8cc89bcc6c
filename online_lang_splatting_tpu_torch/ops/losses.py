"""Image metrics used by the SLAM slice (port of ops/losses.py): PSNR
and the Scharr gradients with reflect padding that build the tracking
gradient mask. Images are channel-first (C, H, W). SSIM / MS-SSIM belong
to the evaluation stack and are not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-channel PSNR over a (C, H, W) pair, averaged."""
    mse = torch.square(img1 - img2).reshape(img1.shape[0], -1).mean(dim=1)
    return (20 * torch.log10(1.0 / torch.sqrt(mse))).mean()


_SCHARR_X = ((3.0, 10.0, 3.0), (0.0, 0.0, 0.0), (-3.0, -10.0, -3.0))
_SCHARR_Y = ((3.0, 0.0, -3.0), (10.0, 0.0, -10.0), (3.0, 0.0, -3.0))


def _depthwise_conv_reflect(img: torch.Tensor, kernel) -> torch.Tensor:
    c = img.shape[0]
    k = torch.tensor(kernel, dtype=img.dtype, device=img.device)
    padded = F.pad(img[None], (1, 1, 1, 1), mode="reflect")
    return F.conv2d(padded, k.expand(c, 1, 3, 3), groups=c)[0]


def image_gradient(image: torch.Tensor):
    """Scharr (grad_v, grad_h) of a (C, H, W) image with the 1/32 normalizer."""
    normalizer = 1.0 / 32.0
    grad_v = normalizer * _depthwise_conv_reflect(image, _SCHARR_X)
    grad_h = normalizer * _depthwise_conv_reflect(image, _SCHARR_Y)
    return grad_v, grad_h


def image_gradient_mask(image: torch.Tensor, eps: float = 0.01):
    """True where every pixel of the 3x3 reflect neighbourhood has
    |value| > eps."""
    c = image.shape[0]
    padded = F.pad(image[None], (1, 1, 1, 1), mode="reflect")
    indicator = (torch.abs(padded) > eps).to(image.dtype)
    ones = torch.ones((c, 1, 3, 3), dtype=image.dtype, device=image.device)
    out = F.conv2d(indicator, ones, groups=c)[0]
    mask = out == 9.0
    return mask, mask

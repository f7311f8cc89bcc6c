"""Image losses and metrics (port of ops/losses.py): L1 with the JAX
package's gradient at a zero residual, PSNR, windowed SSIM and MS-SSIM
(11x11 Gaussian window, sigma 1.5, zero padding), and the Scharr gradients
with reflect padding that build the tracking gradient mask. Images are
channel-first (C, H, W)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import span


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at x == 0 is +1, as `jnp.abs` differentiates
    (torch.abs gives 0 there). Every L1 on a gradient path goes through it:
    where a residual is exactly zero (a language channel with zero
    supervision and zero features) JAX still pushes the parameters."""
    return torch.where(x >= 0, x, -x)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return abs_(x - y).mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-channel PSNR over a (C, H, W) pair, averaged."""
    mse = torch.square(img1 - img2).reshape(img1.shape[0], -1).mean(dim=1)
    return (20 * torch.log10(1.0 / torch.sqrt(mse))).mean()


def _gaussian_window(window_size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=like.device)
    g = torch.exp(-torch.square(x - window_size // 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g).to(like.dtype)


def _ssim_maps(img1, img2, window):
    """(SSIM map, contrast-structure map) with zero 'same' padding."""
    c, k = img1.shape[0], window.shape[0]

    def conv(x):
        return F.conv2d(x[None], window.expand(c, 1, k, k), padding=k // 2, groups=c)[0]

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map, cs_map


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over a (C, H, W) image pair."""
    return _ssim_maps(img1, img2, _gaussian_window(window_size, 1.5, img1))[0].mean()


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
            weights=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003) over a (C, H, W) pair, the
    documented LPIPS substitute. Scales whose downsampled side would drop
    below the window are dropped and the weights renormalized."""
    h, w = img1.shape[-2:]
    n_scales = 1
    while n_scales < len(weights) and min(h, w) // (2 ** n_scales) >= window_size:
        n_scales += 1
    ws = torch.tensor(weights[:n_scales], dtype=img1.dtype, device=img1.device)
    ws = ws / ws.sum()
    window = _gaussian_window(window_size, 1.5, img1)
    vals = []
    for s in range(n_scales):
        ssim_map, cs_map = _ssim_maps(img1, img2, window)
        vals.append(ssim_map.mean() if s == n_scales - 1 else cs_map.mean())
        if s != n_scales - 1:
            img1, img2 = F.avg_pool2d(img1[None], 2)[0], F.avg_pool2d(img2[None], 2)[0]
    vals = torch.clamp(torch.stack(vals), 1e-6, 1.0)
    return torch.prod(vals ** ws)


_SCHARR_X = ((3.0, 10.0, 3.0), (0.0, 0.0, 0.0), (-3.0, -10.0, -3.0))
_SCHARR_Y = ((3.0, 0.0, -3.0), (10.0, 0.0, -10.0), (3.0, 0.0, -3.0))


def _depthwise_conv_reflect(img: torch.Tensor, kernel) -> torch.Tensor:
    c = img.shape[0]
    with span("sync.losses.kernel"):
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

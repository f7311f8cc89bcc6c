"""Language-feature autoencoders, losses and optimizers (port of
models/autoencoder.py).

* `AutoencoderMLP`: Linear / [BatchNorm1d -> ReLU -> Linear]* encoder,
  Linear / [ReLU -> Linear]* decoder, latent and output L2-normalized.
  One-stage 768 -> 15, two-stage 768 -> 32.
* `EncoderDecoderOnline`: the 32 -> 24 -> 15 -> 24 -> 32 codec trained
  online during SLAM.
* offline: l2 + 0.001 (1 - cos), AdamW 4e-4 (weight decay 0.01), 50-step
  linear warmup then cosine decay to 6000. online: l1 + 0.6 (1 - cos),
  Adam 1e-3.

Module names follow the reference checkpoints (`encoder.0`, `encoder.1`
(BatchNorm1d), `encoder.3`, ..., `decoder.0`, `decoder.2`, ...).

Two numerics follow the JAX package rather than torch's own classes:
`OptaxAdam` computes optax's update, lr * m_hat / (sqrt(v_hat) + eps) with
eps outside the square root and no eps_root, the weight decay decoupled
and the schedule read at the count of updates made before this one (so
the first offline step has lr 0); and `BatchNorm1d` in train mode
normalizes with the biased batch variance E[x^2] - E[x]^2 and folds that
same biased variance into its running variance, as flax does (torch's
BatchNorm1d folds in the unbiased one). Momentum 0.1 here is flax's 0.9.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from .init import flax_init_

ONE_STAGE_ENC = (384, 192, 96, 48, 24, 15)
ONE_STAGE_DEC = (24, 48, 96, 192, 384, 384, 768)
TWO_STAGE_ENC = (512, 256, 128, 64, 32)
TWO_STAGE_DEC = (192, 256, 384, 512, 768)


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


class BatchNorm1d(nn.BatchNorm1d):
    """nn.BatchNorm1d whose train mode follows flax (see module doc)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=0)
        var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked += 1
        return (x - mean) * (self.weight * torch.rsqrt(var + self.eps)) + self.bias


class AutoencoderMLP(nn.Module):
    """clip_dim -> low-dim -> clip_dim with normalized latent and output."""

    def __init__(self, encoder_dims: Sequence[int] = ONE_STAGE_ENC,
                 decoder_dims: Sequence[int] = ONE_STAGE_DEC,
                 clip_dim: int = 768, generator: torch.Generator | None = None):
        super().__init__()
        enc, d_in = [], clip_dim
        for i, d in enumerate(encoder_dims):
            if i > 0:
                enc += [BatchNorm1d(d_in, eps=1e-5, momentum=0.1), nn.ReLU()]
            enc.append(nn.Linear(d_in, d))
            d_in = d
        dec = []
        for i, d in enumerate(decoder_dims):
            if i > 0:
                dec.append(nn.ReLU())
            dec.append(nn.Linear(d_in, d))
            d_in = d
        self.encoder = nn.Sequential(*enc)
        self.decoder = nn.Sequential(*dec)
        flax_init_(self, generator)

    def forward(self, x):
        return self.decode(self.encode(x))

    def encode(self, x):
        return _l2n(self.encoder(x))

    def decode(self, z):
        return _l2n(self.decoder(z))


class EncoderDecoderOnline(nn.Module):
    """Second-stage online compressor (32 <-> 15 by default)."""

    def __init__(self, input_dim: int = 32, compressed_dim: int = 15,
                 hidden: int = 24, generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = nn.Sequential(nn.Linear(input_dim, hidden), nn.ReLU(),
                                     nn.Linear(hidden, compressed_dim))
        self.decoder = nn.Sequential(nn.Linear(compressed_dim, hidden), nn.ReLU(),
                                     nn.Linear(hidden, input_dim))
        flax_init_(self, generator)

    def forward(self, x):
        return self.decode(self.encode(x))

    def encode(self, x):
        return _l2n(self.encoder(x))

    def decode(self, z):
        return _l2n(self.decoder(z))


class IncrementalPCA:
    """Streaming PCA (the reference's EncoderDecoderOnline 'pca' mode):
    mean / covariance accumulate across partial_fit batches, components
    from an eigendecomposition. numpy, float64."""

    def __init__(self, n_components: int = 15):
        self.n_components = n_components
        self.count = 0
        self.mean = None
        self.cov_sum = None
        self.components = None

    def partial_fit(self, x):
        x = np.asarray(x, np.float64)
        if self.mean is None:
            self.mean = np.zeros(x.shape[1])
            self.cov_sum = np.zeros((x.shape[1], x.shape[1]))
        n_new = len(x)
        total = self.count + n_new
        delta = x.mean(axis=0) - self.mean
        xc = x - x.mean(axis=0)
        self.cov_sum += xc.T @ xc + np.outer(delta, delta) * (self.count * n_new / total)
        self.mean += delta * n_new / total
        self.count = total
        w, v = np.linalg.eigh(self.cov_sum / max(self.count - 1, 1))
        self.components = v[:, ::-1][:, : self.n_components].T

    @property
    def is_fitted(self):
        return self.components is not None

    def transform(self, x):
        return (np.asarray(x) - self.mean) @ self.components.T

    def inverse_transform(self, z):
        return np.asarray(z) @ self.components + self.mean


def offline_loss(pred, target, cos_weight: float = 0.001):
    l2 = torch.mean(torch.square(pred - target))
    cos = torch.mean(1.0 - torch.sum(_l2n(pred) * _l2n(target), dim=-1))
    return l2 + cos_weight * cos


def online_loss(pred, target, cos_weight: float = 0.6):
    l1 = torch.mean(torch.abs(pred - target))
    cos = torch.mean(1.0 - torch.sum(_l2n(pred) * _l2n(target), dim=-1))
    return l1 + cos_weight * cos


def offline_schedule(lr: float = 4e-4, warmup: int = 50,
                     t_max: int = 6000) -> Callable[[int], float]:
    """Linear warmup from 0 then cosine decay over `t_max` steps
    (optax.join_schedules of linear_schedule and cosine_decay_schedule)."""

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        s = min(count - warmup, t_max)
        return lr * 0.5 * (1.0 + math.cos(math.pi * s / t_max))

    return schedule


class OptaxAdam:
    """Adam / AdamW with optax's numerics (see module doc). `lr` is a
    constant or a schedule of the update count."""

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.params = list(params)
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1.0 - self.b1) * g + self.b1 * m)
            v.copy_((1.0 - self.b2) * (g * g) + self.b2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.sub_(lr * u)


def make_offline_optimizer(model: nn.Module, lr: float = 4e-4) -> OptaxAdam:
    return OptaxAdam(model.parameters(), offline_schedule(lr), weight_decay=0.01)


def make_online_optimizer(model: nn.Module, lr: float = 1e-3) -> OptaxAdam:
    return OptaxAdam(model.parameters(), lr)


def offline_train_step(model: AutoencoderMLP, optimizer: OptaxAdam,
                       x: torch.Tensor) -> torch.Tensor:
    """One step on a (B, clip_dim) batch with BatchNorm batch statistics
    (which also advance the running statistics). Returns the loss."""
    model.train()
    try:
        loss = offline_loss(model(x), x)
    finally:
        model.eval()
    optimizer.step(torch.autograd.grad(loss, optimizer.params))
    return loss.detach()


def online_train_step(model: EncoderDecoderOnline, optimizer: OptaxAdam,
                      x: torch.Tensor) -> torch.Tensor:
    loss = online_loss(model(x), x)
    optimizer.step(torch.autograd.grad(loss, optimizer.params))
    return loss.detach()

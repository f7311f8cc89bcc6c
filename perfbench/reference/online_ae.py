"""Plain reference of the two-stage language codec's online step, as
functional PyTorch in float32, written from the method's description and
not from the program: Online Language Splatting (rpng/online_lang_splatting,
`language/autoencoder/model.py` `EncoderDecoderOnline`, trained from
`utils/slam_backend.py`) compresses the offline autoencoder's 32-d codes
to 15 with a small autoencoder trained during SLAM, one step at a time:

    encode: 32 -> 24 -> ReLU -> 15, then L2-normalised
    decode: 15 -> 24 -> ReLU -> 32, then L2-normalised
    loss:   mean |x_hat - x| + 0.6 * mean(1 - cos(x_hat, x))
    step:   Adam, lr 1e-3, b1 0.9, b2 0.999, eps 1e-8, bias-corrected

Leaves are named as the reference's checkpoints name them (`encoder.0`,
`encoder.2`, `decoder.0`, `decoder.2`, each `.weight` (out, in) and
`.bias`).

Departures from the reference code: where it normalises with torch's
helpers (`F.normalize`, a cosine similarity with its own eps), here each
norm is written out and clamped at 1e-12, the same on rows of unit norm to
rounding; and its step is PyTorch's Adam, whose update
lr * m_hat / (sqrt(v_hat) + eps) is taken here in optax's order of
operations, the same sum rounded another way."""

from __future__ import annotations

import torch

LEAVES = ("encoder.0.weight", "encoder.0.bias", "encoder.2.weight", "encoder.2.bias",
          "decoder.0.weight", "decoder.0.bias", "decoder.2.weight", "decoder.2.bias")
COS_WEIGHT, LR, B1, B2, EPS = 0.6, 1e-3, 0.9, 0.999, 1e-8


def _l2n(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


def _mlp(x, p: dict, part: str):
    h = torch.relu(x @ p[f"{part}.0.weight"].T + p[f"{part}.0.bias"])
    return _l2n(h @ p[f"{part}.2.weight"].T + p[f"{part}.2.bias"])


def encode(x, p: dict):
    """(N, 32) codes -> (N, 15) unit-norm codes."""
    return _mlp(x, p, "encoder")


def decode(z, p: dict):
    """(N, 15) codes -> (N, 32) unit-norm codes."""
    return _mlp(z, p, "decoder")


def loss(x, p: dict):
    """The online loss of reconstructing the rows of x."""
    x_hat = decode(encode(x, p), p)
    cos = (x_hat * x).sum(-1) / (torch.clamp(torch.linalg.norm(x_hat, dim=-1), min=1e-12)
                                 * torch.clamp(torch.linalg.norm(x, dim=-1), min=1e-12))
    return (x_hat - x).abs().mean() + COS_WEIGHT * (1.0 - cos).mean()


def grads(x, p: dict) -> dict:
    """The loss's gradient in every leaf, by autograd."""
    leaves = {k: p[k].detach().float().requires_grad_(True) for k in LEAVES}
    g = torch.autograd.grad(loss(x.float(), leaves), [leaves[k] for k in LEAVES])
    return dict(zip(LEAVES, g))


def adam(p: dict, g: dict, mu: dict, nu: dict, count: int) -> dict:
    """One Adam step of the leaves p with the gradients g, the moments mu
    and nu and the count of steps taken before it; returns the new leaves."""
    n = torch.tensor(float(count + 1), dtype=torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(B1, dtype=torch.float32), n)
    c2 = 1.0 - torch.pow(torch.tensor(B2, dtype=torch.float32), n)
    out = {}
    for k in LEAVES:
        m = B1 * mu[k].float() + (1.0 - B1) * g[k]
        v = B2 * nu[k].float() + (1.0 - B2) * g[k] * g[k]
        c1k, c2k = c1.to(m.device), c2.to(m.device)
        out[k] = p[k].float() - LR * (m / c1k) / (torch.sqrt(v / c2k) + EPS)
    return out

"""CLIP text transformer (port of models/text_tower.py): token plus
learned positional embedding, pre-LN residual attention blocks (width
768, 12 heads, MLP 4x, erf GELU) under a causal mask, ln_final, and
pooling at the end-of-text token through the text projection.

Module names follow open_clip's text state_dict (`token_embedding`,
`transformer.resblocks.{i}.attn.in_proj_weight`, `ln_final`,
`text_projection`, ...). Attention is written out with matmul and
softmax, as the JAX package computes it in plain XLA.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from .init import flax_init_, lecun_normal_


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask):
        n, length, width = x.shape
        d = width // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(n, length, self.heads, d).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        logits = (q / math.sqrt(d)) @ k.transpose(-1, -2)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        out = torch.softmax(logits, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(n, length, width))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)), ("gelu", nn.GELU()),
            ("c_proj", nn.Linear(4 * width, width))]))

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))


class TextTower(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 768, heads: int = 12, layers: int = 16,
                 embed_dim: int = 768, generator: torch.Generator | None = None):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = _Transformer(width, heads, layers)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))
        self.register_buffer("attn_mask", torch.tril(torch.ones(
            context_length, context_length, dtype=torch.bool)), persistent=False)
        flax_init_(self, generator)
        with torch.no_grad():
            self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
            self.positional_embedding.normal_(0.0, 0.01, generator=generator)
            self.text_projection.normal_(0.0, 0.02, generator=generator)
            for block in self.transformer.resblocks:
                lecun_normal_(block.attn.in_proj_weight, width, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (N, context_length) int -> (N, embed_dim), unnormalized
        (the reference's encode_text(normalize=False))."""
        x = self.token_embedding(tokens) + self.positional_embedding[None]
        for block in self.transformer.resblocks:
            x = block(x, self.attn_mask)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection

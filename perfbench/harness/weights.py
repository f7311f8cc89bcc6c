"""The extractor's weights, drawn on the device from the run's seed in the
reference checkpoints' key layout (reference/extractor.py `layout`): one
normal draw of every float tensor at once from a `torch.Generator` on the
device, cut into views and scaled by kind. The scales keep activations of
order one through the tower: fan-in scaled kernels, small biases, norms
near identity, BatchNorm statistics near (0, 1), and layer scales of 0.2
(a trained ConvNeXt's are of that order, far above the 1e-6 of an
untrained one, so every block shapes the output)."""

from __future__ import annotations

import torch

from perfbench.reference.extractor import layout


def extractor(cfg: dict, seed: int, device, use_hr: bool = True):
    """The port's `LangFeatureExtractor` on the seed's weights."""
    from online_lang_splatting_tpu_torch.models.sed import LangFeatureExtractor

    w = draw(cfg, seed, device)
    return LangFeatureExtractor(
        w["visual"], w["hr"], w["ae"], encoder_dims=cfg["ae_encoder"],
        decoder_dims=cfg["ae_decoder"], use_hr=use_hr, clip_resolution=cfg["clip_resolution"],
        depths=cfg["depths"], dims=cfg["dims"], embed_dim=cfg["embed_dim"],
        clip_dim=cfg["clip_dim"], device=device)


def draw(cfg: dict, seed: int, device) -> dict:
    """{"visual": state, "hr": state, "ae": state} on `device`."""
    spec = layout(cfg)
    sizes = [(m, key, shape, kind) for m, entries in spec.items() for key, shape, kind in entries]
    total = sum(_numel(shape) for _, _, shape, kind in sizes if kind != "bn_count")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: dict = {m: {} for m in spec}
    pos = 0
    for model, key, shape, kind in sizes:
        if kind == "bn_count":
            out[model][key] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = _numel(shape)
        z = flat[pos:pos + n].view(shape)
        pos += n
        out[model][key] = _scale(z, kind, shape)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _scale(z: torch.Tensor, kind: str, shape) -> torch.Tensor:
    if kind == "weight":
        return z * (1.0 / _numel(shape[1:])) ** 0.5
    if kind == "bias":
        return z * 0.02
    if kind in ("ln_w", "bn_w"):
        return 1.0 + 0.1 * z
    if kind in ("ln_b", "bn_b", "bn_mean"):
        return 0.1 * z
    if kind == "bn_var":
        return torch.exp(0.2 * z)
    if kind == "gamma":
        return 0.2 * z
    raise ValueError(f"unknown kind {kind!r}")

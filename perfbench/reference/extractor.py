"""Plain reference of the dense language extractor: SED's ConvNeXt-L CLIP
visual tower (OpenCLIP `convnext_large_d_320`, dense per-location head),
the HR head and the one-stage autoencoder's encoder, as functional
PyTorch on a dict of weights, float32.

Written from the published architecture (Xie et al., "SED", CVPR 2024;
the reference's `language/language_features.py` and
`create_lang_model.py`), not from the program: nothing here imports the
program, and the weights are the benchmark's own (`layout` names every
tensor; the harness draws them). The transposed convolutions of the HR
head are `F.conv_transpose2d` itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CLIP_PIXEL_MEAN = (122.7709383, 116.7460125, 104.09373615)
CLIP_PIXEL_STD = (68.5005327, 66.6321579, 70.3231630)
LN_EPS, BN_EPS = 1e-6, 1e-5


def layout(cfg: dict) -> dict:
    """{model: [(key, shape, kind), ...]} of the three models, in the
    state_dict key layout of the reference checkpoints (open_clip's
    `visual.*` without the prefix, the HR head's `model.*` without it, the
    autoencoder's `encoder.*` / `decoder.*`). `kind` says how a tensor is
    drawn: weight, bias, ln_w, ln_b, bn_w, bn_b, bn_mean, bn_var, bn_count,
    gamma."""
    depths, dims, embed = cfg["depths"], cfg["dims"], cfg["embed_dim"]
    vis = [("trunk.stem.0.weight", (dims[0], 3, 4, 4), "weight"),
           ("trunk.stem.0.bias", (dims[0],), "bias"),
           ("trunk.stem.1.weight", (dims[0],), "ln_w"),
           ("trunk.stem.1.bias", (dims[0],), "ln_b")]
    for i, (depth, d) in enumerate(zip(depths, dims)):
        s = f"trunk.stages.{i}"
        if i > 0:
            vis += [(f"{s}.downsample.0.weight", (dims[i - 1],), "ln_w"),
                    (f"{s}.downsample.0.bias", (dims[i - 1],), "ln_b"),
                    (f"{s}.downsample.1.weight", (d, dims[i - 1], 2, 2), "weight"),
                    (f"{s}.downsample.1.bias", (d,), "bias")]
        for j in range(depth):
            b = f"{s}.blocks.{j}"
            vis += [(f"{b}.gamma", (d,), "gamma"),
                    (f"{b}.conv_dw.weight", (d, 1, 7, 7), "weight"),
                    (f"{b}.conv_dw.bias", (d,), "bias"),
                    (f"{b}.norm.weight", (d,), "ln_w"),
                    (f"{b}.norm.bias", (d,), "ln_b"),
                    (f"{b}.mlp.fc1.weight", (4 * d, d), "weight"),
                    (f"{b}.mlp.fc1.bias", (4 * d,), "bias"),
                    (f"{b}.mlp.fc2.weight", (d, 4 * d), "weight"),
                    (f"{b}.mlp.fc2.bias", (d,), "bias")]
    vis += [("trunk.head.norm.weight", (dims[-1],), "ln_w"),
            ("trunk.head.norm.bias", (dims[-1],), "ln_b"),
            ("head.mlp.fc1.weight", (2 * embed, dims[-1]), "weight"),
            ("head.mlp.fc1.bias", (2 * embed,), "bias"),
            ("head.mlp.fc2.weight", (embed, 2 * embed), "weight")]

    def conv(name, cout, cin, k):
        return [(f"{name}.weight", (cout, cin, k, k), "weight"), (f"{name}.bias", (cout,), "bias")]

    def bn(name, c):
        return [(f"{name}.weight", (c,), "bn_w"), (f"{name}.bias", (c,), "bn_b"),
                (f"{name}.running_mean", (c,), "bn_mean"),
                (f"{name}.running_var", (c,), "bn_var"),
                (f"{name}.num_batches_tracked", (), "bn_count")]

    def cbr(name, cin, cout, transpose=False):
        shape = (cin, cout, 4, 4) if transpose else (cout, cin, 3, 3)
        return ([(f"{name}.0.weight", shape, "weight"), (f"{name}.0.bias", (cout,), "bias")]
                + bn(f"{name}.1", cout))

    def fusion(name, c, low):
        out = conv(f"{name}.low_res_align", c, low, 1) if low != c else []
        return (out + cbr(f"{name}.fusion", 2 * c, c) + conv(f"{name}.attention.0", c, c, 3)
                + bn(f"{name}.attention.1", c) + conv(f"{name}.attention.3", c, c, 1))

    hr = (cbr("initial_conv", embed, 512) + cbr("upsample1", 512, 512, True)
          + fusion("attention_fusion1", 512, dims[1]) + cbr("upsample2", 512, 256, True)
          + fusion("attention_fusion2", 256, dims[0]) + cbr("upsample3", 256, 128, True)
          + conv("final_conv", cfg["clip_dim"], 128, 1))

    ae, d_in, k = [], cfg["clip_dim"], 0
    for i, d in enumerate(cfg["ae_encoder"]):
        if i > 0:
            ae += bn(f"encoder.{k}", d_in)
            k += 2
        ae += [(f"encoder.{k}.weight", (d, d_in), "weight"), (f"encoder.{k}.bias", (d,), "bias")]
        k, d_in = k + 1, d
    for i, d in enumerate(cfg["ae_decoder"]):
        j = 2 * i
        ae += [(f"decoder.{j}.weight", (d, d_in), "weight"), (f"decoder.{j}.bias", (d,), "bias")]
        d_in = d
    return {"visual": vis, "hr": hr, "ae": ae}


def _ln_nchw(x, w, b):
    return F.layer_norm(x.permute(0, 2, 3, 1), w.shape, w, b, LN_EPS).permute(0, 3, 1, 2)


def tower(x: torch.Tensor, w: dict, cfg: dict) -> dict:
    """(1, 3, S, S) normalized image -> res2, res3 (NCHW) and the dense
    CLIP map clip_vis_dense (NCHW, embed channels)."""
    x = F.conv2d(x, w["trunk.stem.0.weight"], w["trunk.stem.0.bias"], stride=4)
    x = _ln_nchw(x, w["trunk.stem.1.weight"], w["trunk.stem.1.bias"])
    out = {}
    for i, depth in enumerate(cfg["depths"]):
        s = f"trunk.stages.{i}"
        if i > 0:
            x = _ln_nchw(x, w[f"{s}.downsample.0.weight"], w[f"{s}.downsample.0.bias"])
            x = F.conv2d(x, w[f"{s}.downsample.1.weight"], w[f"{s}.downsample.1.bias"], stride=2)
        for j in range(depth):
            b = f"{s}.blocks.{j}"
            y = F.conv2d(x, w[f"{b}.conv_dw.weight"], w[f"{b}.conv_dw.bias"], padding=3,
                         groups=x.shape[1]).permute(0, 2, 3, 1)
            y = F.layer_norm(y, y.shape[-1:], w[f"{b}.norm.weight"], w[f"{b}.norm.bias"], LN_EPS)
            y = F.linear(F.gelu(F.linear(y, w[f"{b}.mlp.fc1.weight"], w[f"{b}.mlp.fc1.bias"])),
                         w[f"{b}.mlp.fc2.weight"], w[f"{b}.mlp.fc2.bias"])
            x = x + (w[f"{b}.gamma"] * y).permute(0, 3, 1, 2)
        out[f"res{i + 2}"] = x
    y = F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], w["trunk.head.norm.weight"],
                     w["trunk.head.norm.bias"], LN_EPS)
    y = F.linear(F.gelu(F.linear(y, w["head.mlp.fc1.weight"], w["head.mlp.fc1.bias"])),
                 w["head.mlp.fc2.weight"])
    out["clip_vis_dense"] = y.permute(0, 3, 1, 2)
    return out


def _bn(x, w, name):
    return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"],
                        w[f"{name}.weight"], w[f"{name}.bias"], False, 0.0, BN_EPS)


def _cbr(x, w, name, transpose=False):
    if transpose:
        x = F.conv_transpose2d(x, w[f"{name}.0.weight"], w[f"{name}.0.bias"], stride=2,
                               padding=1)
    else:
        x = F.conv2d(x, w[f"{name}.0.weight"], w[f"{name}.0.bias"], padding=1)
    return F.relu(_bn(x, w, f"{name}.1"))


def _resize(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)


def _fusion(high, low, w, name):
    if f"{name}.low_res_align.weight" in w:
        low = F.conv2d(low, w[f"{name}.low_res_align.weight"], w[f"{name}.low_res_align.bias"])
    fused = _cbr(torch.cat([high, low], 1), w, f"{name}.fusion")
    att = F.conv2d(fused, w[f"{name}.attention.0.weight"], w[f"{name}.attention.0.bias"],
                   padding=1)
    att = F.relu(_bn(att, w, f"{name}.attention.1"))
    att = torch.sigmoid(F.conv2d(att, w[f"{name}.attention.3.weight"],
                                 w[f"{name}.attention.3.bias"]))
    return fused * att + fused


def hr_head(fv, res3, res2, w: dict) -> torch.Tensor:
    x = _cbr(_cbr(fv, w, "initial_conv"), w, "upsample1", transpose=True)
    x = _fusion(x, _resize(res3, x.shape[-2:]), w, "attention_fusion1")
    x = _cbr(x, w, "upsample2", transpose=True)
    x = _fusion(x, _resize(res2, x.shape[-2:]), w, "attention_fusion2")
    x = _cbr(x, w, "upsample3", transpose=True)
    return F.conv2d(x, w["final_conv.weight"], w["final_conv.bias"])


def ae_encode(x: torch.Tensor, w: dict, cfg: dict) -> torch.Tensor:
    """(N, clip_dim) -> (N, low_dim) unit-norm codes (eval-mode BatchNorm)."""
    k = 0
    for i in range(len(cfg["ae_encoder"])):
        if i > 0:
            x = F.relu(_bn(x, w, f"encoder.{k}"))
            k += 2
        x = F.linear(x, w[f"encoder.{k}.weight"], w[f"encoder.{k}.bias"])
        k += 1
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


@torch.no_grad()
def encode_frame(rgb: torch.Tensor, weights: dict, cfg: dict) -> torch.Tensor:
    """(H, W, 3) float32 RGB in [0, 255] -> (S/4, S/4, low_dim) codes: CLIP
    normalization, bilinear resize to S x S, tower, HR head, AE encoder."""
    mean = torch.tensor(CLIP_PIXEL_MEAN, dtype=torch.float32, device=rgb.device)
    std = torch.tensor(CLIP_PIXEL_STD, dtype=torch.float32, device=rgb.device)
    x = ((rgb.float() - mean) / std).permute(2, 0, 1)[None]
    x = _resize(x, cfg["clip_resolution"])
    feats = tower(x, weights["visual"], cfg)
    hr = hr_head(feats["clip_vis_dense"], feats["res3"], feats["res2"], weights["hr"])
    _, c, h, wd = hr.shape
    codes = ae_encode(hr[0].permute(1, 2, 0).reshape(-1, c), weights["ae"], cfg)
    return codes.reshape(h, wd, -1)

"""Carry state into the port from numpy.

The input is the JAX package's state with every field already converted to
numpy by the caller (the port never imports JAX), so both packages can
start a tracking run or a mapping iteration from the same map, and the
port's language models load the flax parameter trees that
tools/convert_weights.py writes (`language_from_numpy`, the inverse of
that tool's layout changes). The `*_to_numpy` functions go the other way,
from the port's state dicts to those trees, so a weights directory can be
written from the port's own (seeded) models.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import gaussians as G
from .slam.camera import Camera


def gaussians_from_numpy(tree: dict, device="cpu"):
    """{field: ndarray} -> (GaussianParams, GaussianAux, AdamState).

    Keys: the GaussianParams fields (xyz, features_dc, features_rest,
    scaling, rotation, opacity, language); the GaussianAux fields (only
    `active` is required, the others default to an empty map's values);
    optionally "mu.<field>", "nu.<field>" and "count" for the Adam state
    (default zero)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    params = G.GaussianParams(*(t(tree[f]) for f in G.GaussianParams._fields))
    cap = params.xyz.shape[0]
    aux = G.empty_aux(cap, device)._asdict()
    for f in G.GaussianAux._fields:
        if f in tree:
            aux[f] = t(tree[f]).to(aux[f].dtype)
    aux = G.GaussianAux(**aux)
    opt = G.init_adam(params)
    if "mu.xyz" in tree:
        opt = G.AdamState(
            mu=G.GaussianParams(*(t(tree[f"mu.{f}"]) for f in G.GaussianParams._fields)),
            nu=G.GaussianParams(*(t(tree[f"nu.{f}"]) for f in G.GaussianParams._fields)),
            count=t(np.int32(tree.get("count", 0))),
        )
    return params, aux, opt


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _dense(node) -> dict:
    """flax Dense {kernel (in, out), bias} -> nn.Linear {weight, bias}."""
    out = {"weight": _tensor(np.asarray(node["kernel"]).T)}
    if "bias" in node:
        out["bias"] = _tensor(node["bias"])
    return out


def _conv(node) -> dict:
    """flax Conv kernel HWIO -> OIHW; a depthwise (7, 7, 1, C) kernel
    becomes (C, 1, 7, 7). The same permutation takes a flax ConvTranspose
    kernel (kh, kw, out, in) to torch's (in, out, kh, kw)."""
    return {"weight": _tensor(np.transpose(node["kernel"], (3, 2, 0, 1))),
            "bias": _tensor(node["bias"])}


def _norm(node) -> dict:
    return {"weight": _tensor(node["scale"]), "bias": _tensor(node["bias"])}


def _batchnorm(params, stats) -> dict:
    return {**_norm(params), "running_mean": _tensor(stats["mean"]),
            "running_var": _tensor(stats["var"]),
            "num_batches_tracked": torch.tensor(0)}


def _put(sd: dict, prefix: str, entries: dict):
    for k, v in entries.items():
        sd[f"{prefix}.{k}"] = v


def visual_from_numpy(p: dict) -> dict:
    """ConvNeXtCLIPVisual params -> models/convnext_clip state_dict. The
    scanned blocks (stacked on a leading depth axis under
    `stage{i}/blocks/block`) become one module per block."""
    sd: dict = {}
    _put(sd, "trunk.stem.0", _conv(p["stem_conv"]))
    _put(sd, "trunk.stem.1", _norm(p["stem_norm"]))
    s = 0
    while f"stage{s}" in p:
        stage, pre = p[f"stage{s}"], f"trunk.stages.{s}"
        if "ds_norm" in stage:
            _put(sd, f"{pre}.downsample.0", _norm(stage["ds_norm"]))
            _put(sd, f"{pre}.downsample.1", _conv(stage["ds_conv"]))
        blocks = stage["blocks"]["block"]
        for b in range(np.asarray(blocks["gamma"]).shape[0]):
            def pick(node):
                return {k: np.asarray(v)[b] for k, v in node.items()}

            bp = f"{pre}.blocks.{b}"
            _put(sd, f"{bp}.conv_dw", _conv(pick(blocks["dwconv"])))
            _put(sd, f"{bp}.norm", _norm(pick(blocks["norm"])))
            _put(sd, f"{bp}.mlp.fc1", _dense(pick(blocks["mlp_fc1"])))
            _put(sd, f"{bp}.mlp.fc2", _dense(pick(blocks["mlp_fc2"])))
            sd[f"{bp}.gamma"] = _tensor(np.asarray(blocks["gamma"])[b])
        s += 1
    _put(sd, "trunk.head.norm", _norm(p["head_norm"]))
    _put(sd, "head.mlp.fc1", _dense(p["head_fc1"]))
    _put(sd, "head.mlp.fc2", _dense(p["head_fc2"]))
    return sd


def hr_from_numpy(tree: dict) -> dict:
    """HighResLanguageFeatureNet {params, batch_stats} -> models/hr_net
    state_dict."""
    p, st = tree["params"], tree["batch_stats"]
    sd: dict = {}

    def conv_bn(prefix, pp, ss):
        _put(sd, f"{prefix}.0", _conv(pp["conv"]))
        _put(sd, f"{prefix}.1", _batchnorm(pp["bn"], ss["bn"]))

    conv_bn("initial_conv", p["initial"], st["initial"])
    for i in (1, 2, 3):
        conv_bn(f"upsample{i}", p[f"up{i}"], st[f"up{i}"])
    for i in (1, 2):
        fp, fs, pre = p[f"fuse{i}"], st[f"fuse{i}"], f"attention_fusion{i}"
        if "align" in fp:
            _put(sd, f"{pre}.low_res_align", _conv(fp["align"]))
        conv_bn(f"{pre}.fusion", fp["fusion"], fs["fusion"])
        conv_bn(f"{pre}.attention", fp["attn_conv"], fs["attn_conv"])
        _put(sd, f"{pre}.attention.3", _conv(fp["attn_proj"]))
    _put(sd, "final_conv", _conv(p["final"]))
    return sd


def ae_from_numpy(tree: dict) -> dict:
    """AutoencoderMLP {params, batch_stats} -> models/autoencoder
    state_dict: encoder fc_i -> encoder.{3i}, bn_i -> encoder.{3i-2};
    decoder fc_i -> decoder.{2i}."""
    p, st = tree["params"], tree["batch_stats"]
    sd: dict = {}
    for name, node in p["encoder"].items():
        i = int(name[2:])
        if name.startswith("fc"):
            _put(sd, f"encoder.{3 * i}", _dense(node))
        else:
            _put(sd, f"encoder.{3 * i - 2}", _batchnorm(node, st["encoder"][name]))
    for name, node in p["decoder"].items():
        _put(sd, f"decoder.{2 * int(name[2:])}", _dense(node))
    return sd


def online_ae_from_numpy(p: dict) -> dict:
    """EncoderDecoderOnline params -> models/autoencoder state_dict."""
    sd: dict = {}
    for name, key in (("enc1", "encoder.0"), ("enc2", "encoder.2"),
                      ("dec1", "decoder.0"), ("dec2", "decoder.2")):
        _put(sd, key, _dense(p[name]))
    return sd


def text_from_numpy(p: dict) -> dict:
    """TextTower params -> models/text_tower state_dict (flax's per-head
    query/key/value kernels fold back into one in_proj)."""
    sd = {"token_embedding.weight": _tensor(p["token_embedding"]),
          "positional_embedding": _tensor(p["positional_embedding"]),
          "text_projection": _tensor(p["text_projection"])}
    _put(sd, "ln_final", _norm(p["ln_final"]))
    i = 0
    while f"resblock{i}" in p:
        blk, pre = p[f"resblock{i}"], f"transformer.resblocks.{i}"
        attn = blk["attn"]
        width = np.asarray(attn["query"]["kernel"]).shape[0]
        sd[f"{pre}.attn.in_proj_weight"] = _tensor(np.concatenate(
            [np.asarray(attn[n]["kernel"]).reshape(width, width).T
             for n in ("query", "key", "value")]))
        sd[f"{pre}.attn.in_proj_bias"] = _tensor(np.concatenate(
            [np.asarray(attn[n]["bias"]).reshape(-1) for n in ("query", "key", "value")]))
        sd[f"{pre}.attn.out_proj.weight"] = _tensor(
            np.asarray(attn["out"]["kernel"]).reshape(width, width).T)
        sd[f"{pre}.attn.out_proj.bias"] = _tensor(attn["out"]["bias"])
        _put(sd, f"{pre}.ln_1", _norm(blk["ln_1"]))
        _put(sd, f"{pre}.ln_2", _norm(blk["ln_2"]))
        _put(sd, f"{pre}.mlp.c_fc", _dense(blk["mlp_c_fc"]))
        _put(sd, f"{pre}.mlp.c_proj", _dense(blk["mlp_c_proj"]))
        i += 1
    return sd


def language_from_numpy(visual=None, hr=None, ae=None, online_ae=None,
                        text=None) -> dict:
    """The JAX package's language parameter trees (the layouts
    tools/convert_weights.py writes), as numpy, -> the port's state
    dicts, keyed like the arguments given: `visual` (ConvNeXtCLIPVisual
    params), `hr` and `ae` ({params, batch_stats}), `online_ae`
    (EncoderDecoderOnline params) and `text` (TextTower params)."""
    fns = dict(visual=visual_from_numpy, hr=hr_from_numpy, ae=ae_from_numpy,
               online_ae=online_ae_from_numpy, text=text_from_numpy)
    given = dict(visual=visual, hr=hr, ae=ae, online_ae=online_ae, text=text)
    return {k: fns[k](v) for k, v in given.items() if v is not None}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _dense_np(sd: dict, prefix: str) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T.copy()}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _conv_np(sd: dict, prefix: str) -> dict:
    return {"kernel": np.transpose(_np(sd[f"{prefix}.weight"]), (2, 3, 1, 0)).copy(),
            "bias": _np(sd[f"{prefix}.bias"])}


def _norm_np(sd: dict, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _stats_np(sd: dict, prefix: str) -> dict:
    return {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}


def visual_to_numpy(sd: dict) -> dict:
    """The inverse of `visual_from_numpy` (blocks stacked on a depth axis)."""
    p = {"stem_conv": _conv_np(sd, "trunk.stem.0"), "stem_norm": _norm_np(sd, "trunk.stem.1"),
         "head_norm": _norm_np(sd, "trunk.head.norm"),
         "head_fc1": _dense_np(sd, "head.mlp.fc1"), "head_fc2": _dense_np(sd, "head.mlp.fc2")}
    s = 0
    while f"trunk.stages.{s}.blocks.0.gamma" in sd:
        pre, stage = f"trunk.stages.{s}", {}
        if f"{pre}.downsample.0.weight" in sd:
            stage["ds_norm"] = _norm_np(sd, f"{pre}.downsample.0")
            stage["ds_conv"] = _conv_np(sd, f"{pre}.downsample.1")
        blocks = []
        while f"{pre}.blocks.{len(blocks)}.gamma" in sd:
            bp = f"{pre}.blocks.{len(blocks)}"
            blocks.append({"dwconv": _conv_np(sd, f"{bp}.conv_dw"), "norm": _norm_np(sd, f"{bp}.norm"),
                           "mlp_fc1": _dense_np(sd, f"{bp}.mlp.fc1"),
                           "mlp_fc2": _dense_np(sd, f"{bp}.mlp.fc2"),
                           "gamma": _np(sd[f"{bp}.gamma"])})

        def stack(nodes):
            if isinstance(nodes[0], dict):
                return {k: stack([nd[k] for nd in nodes]) for k in nodes[0]}
            return np.stack(nodes)

        stage["blocks"] = {"block": stack(blocks)}
        p[f"stage{s}"] = stage
        s += 1
    return p


def hr_to_numpy(sd: dict) -> dict:
    """The inverse of `hr_from_numpy`: {params, batch_stats}."""
    params, stats = {}, {}

    def conv_bn(prefix):
        return ({"conv": _conv_np(sd, f"{prefix}.0"), "bn": _norm_np(sd, f"{prefix}.1")},
                {"bn": _stats_np(sd, f"{prefix}.1")})

    params["initial"], stats["initial"] = conv_bn("initial_conv")
    for i in (1, 2, 3):
        params[f"up{i}"], stats[f"up{i}"] = conv_bn(f"upsample{i}")
    for i in (1, 2):
        pre, fp, fs = f"attention_fusion{i}", {}, {}
        if f"{pre}.low_res_align.weight" in sd:
            fp["align"] = _conv_np(sd, f"{pre}.low_res_align")
        fp["fusion"], fs["fusion"] = conv_bn(f"{pre}.fusion")
        fp["attn_conv"], fs["attn_conv"] = conv_bn(f"{pre}.attention")
        fp["attn_proj"] = _conv_np(sd, f"{pre}.attention.3")
        params[f"fuse{i}"], stats[f"fuse{i}"] = fp, fs
    params["final"] = _conv_np(sd, "final_conv")
    return {"params": params, "batch_stats": stats}


def ae_to_numpy(sd: dict) -> dict:
    """The inverse of `ae_from_numpy`: encoder.{3i} -> fc_i, encoder.{3i-2}
    -> bn_i, decoder.{2i} -> fc_i."""
    enc, enc_stats, dec = {}, {}, {}
    for key in sd:
        part, idx, leaf = key.split(".")
        if leaf != "weight":
            continue
        i = int(idx)
        if part == "decoder":
            dec[f"fc{i // 2}"] = _dense_np(sd, f"decoder.{i}")
        elif i % 3 == 0:
            enc[f"fc{i // 3}"] = _dense_np(sd, f"encoder.{i}")
        else:
            enc[f"bn{(i + 2) // 3}"] = _norm_np(sd, f"encoder.{i}")
            enc_stats[f"bn{(i + 2) // 3}"] = _stats_np(sd, f"encoder.{i}")
    return {"params": {"encoder": enc, "decoder": dec}, "batch_stats": {"encoder": enc_stats}}


def text_to_numpy(sd: dict, heads: int) -> dict:
    """The inverse of `text_from_numpy`; `heads` splits the attention
    kernels into flax's (width, heads, head_dim) layout."""
    p = {"token_embedding": _np(sd["token_embedding.weight"]),
         "positional_embedding": _np(sd["positional_embedding"]),
         "text_projection": _np(sd["text_projection"]),
         "ln_final": _norm_np(sd, "ln_final")}
    i = 0
    while f"transformer.resblocks.{i}.attn.in_proj_weight" in sd:
        pre = f"transformer.resblocks.{i}"
        w_qkv = _np(sd[f"{pre}.attn.in_proj_weight"])
        b_qkv = _np(sd[f"{pre}.attn.in_proj_bias"])
        width = w_qkv.shape[1]
        hd = width // heads
        attn = {name: {"kernel": w.T.reshape(width, heads, hd).copy(),
                       "bias": b.reshape(heads, hd)}
                for name, w, b in zip(("query", "key", "value"), np.split(w_qkv, 3),
                                      np.split(b_qkv, 3))}
        attn["out"] = {"kernel": _np(sd[f"{pre}.attn.out_proj.weight"]).T.reshape(
            heads, hd, width).copy(), "bias": _np(sd[f"{pre}.attn.out_proj.bias"])}
        p[f"resblock{i}"] = {"ln_1": _norm_np(sd, f"{pre}.ln_1"),
                             "ln_2": _norm_np(sd, f"{pre}.ln_2"), "attn": attn,
                             "mlp_c_fc": _dense_np(sd, f"{pre}.mlp.c_fc"),
                             "mlp_c_proj": _dense_np(sd, f"{pre}.mlp.c_proj")}
        i += 1
    return p


def text_config(tree: dict) -> dict:
    """TextTower keyword arguments read off a text parameter tree."""
    q = np.asarray(tree["resblock0"]["attn"]["query"]["kernel"])
    layers = 0
    while f"resblock{layers}" in tree:
        layers += 1
    return dict(vocab_size=np.asarray(tree["token_embedding"]).shape[0],
                context_length=np.asarray(tree["positional_embedding"]).shape[0],
                width=q.shape[0], heads=q.shape[1], layers=layers,
                embed_dim=np.asarray(tree["text_projection"]).shape[1])


def cameras_from_numpy(frames: dict, intrinsics: dict, device="cpu") -> dict:
    """{uid: {"image" (3,H,W), "depth" (H,W), "r", "t", "r_gt", "t_gt",
    optional "exposure_a", "exposure_b"}} + intrinsics {fx, fy, cx, cy,
    width, height} -> {uid: Camera}."""
    from .ops import graphics

    fx, fy = intrinsics["fx"], intrinsics["fy"]
    w, h = intrinsics["width"], intrinsics["height"]
    cams = {}
    for uid, f in frames.items():
        image = np.asarray(f["image"], np.float32)
        cam = Camera(
            uid=uid, image=torch.as_tensor(image, device=device),
            depth=np.asarray(f["depth"], np.float32),
            r_gt=np.asarray(f["r_gt"], np.float32),
            t_gt=np.asarray(f["t_gt"], np.float32),
            fx=fx, fy=fy, cx=intrinsics["cx"], cy=intrinsics["cy"],
            fovx=graphics.focal_to_fov(fx, w), fovy=graphics.focal_to_fov(fy, h),
            height=h, width=w,
            r=np.asarray(f["r"], np.float32), t=np.asarray(f["t"], np.float32),
            exposure_a=float(f.get("exposure_a", 0.0)),
            exposure_b=float(f.get("exposure_b", 0.0)),
            image_host=image,
        )
        cams[uid] = cam
    return cams


def lpips_from_numpy(params: dict, device="cpu") -> dict:
    """The JAX package's LPIPS parameter tree ({"convs": [(weight, bias)],
    "lins": [weight]}, OIHW, as numpy) -> the port's (eval/lpips.py)."""
    from .eval.lpips import _tree

    return _tree(params["convs"], params["lins"], device)


def online_ae_to_numpy(state_dict: dict) -> dict:
    """models/autoencoder EncoderDecoderOnline state_dict -> the JAX
    package's params tree (the inverse of `online_ae_from_numpy`)."""
    out = {}
    for name, key in (("enc1", "encoder.0"), ("enc2", "encoder.2"),
                      ("dec1", "decoder.0"), ("dec2", "decoder.2")):
        out[name] = {"kernel": state_dict[f"{key}.weight"].detach().cpu().numpy().T.copy(),
                     "bias": state_dict[f"{key}.bias"].detach().cpu().numpy()}
    return out


def _nested(flat, prefix: str) -> dict:
    """'prefix/a/b' keys of an npz -> {a: {b: array}}."""
    tree: dict = {}
    for key in flat:
        if key.startswith(prefix + "/"):
            node = tree
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(flat[key])
    return tree


def snapshot_from_numpy(flat, device="cpu") -> dict:
    """A slam/checkpoint.py snapshot of either package ({key: array}, the
    npz's contents) -> the port's state:

    params / opt / aux (tensors on `device`), kf_opt (the keyframe pose
    Adam, or None), cams {kf id: {r, t, exposure[, lang, coco]}} (numpy),
    occ {kf id: visibility}, traj {frame: r (9) + t (3)}, the counters
    (iteration_count, frame_idx, cap, kf_indices, fe_kf_indices, window,
    median_depth), online_ae (a models/autoencoder state_dict, or None)
    and, from a snapshot the port wrote, torch_rng (the backend
    generator's state) and torch_online_ae_opt (the online codec's Adam).
    The JAX package's `rng`, a JAX PRNG key, has no use here."""
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    def named(tree_type, node):
        return tree_type(*(t(node[f]) for f in tree_type._fields))

    params, opt, aux = (_nested(flat, k) for k in ("params", "opt", "aux"))
    state = dict(
        params=named(G.GaussianParams, params),
        opt=G.AdamState(mu=named(G.GaussianParams, opt["mu"]),
                        nu=named(G.GaussianParams, opt["nu"]), count=t(opt["count"])),
        aux=named(G.GaussianAux, aux),
        kf_opt=None,
        cams={int(k): v for k, v in _nested(flat, "cam").items()},
        occ={int(k): v for k, v in _nested(flat, "occ").items()},
        traj={int(k): v for k, v in _nested(flat, "traj").items()},
        online_ae=None, torch_rng=None, torch_online_ae_opt=None,
    )
    kf = _nested(flat, "kf_opt")
    if kf:
        state["kf_opt"] = (tuple(t(kf["0"][str(i)]) for i in range(4)),
                           tuple(t(kf["1"][str(i)]) for i in range(4)), t(kf["2"]))
    for key in ("iteration_count", "frame_idx", "cap"):
        state[key] = int(flat[key])
    for key in ("kf_indices", "fe_kf_indices", "window"):
        state[key] = [int(i) for i in np.asarray(flat[key])]
    state["median_depth"] = float(flat["median_depth"])
    ae = _nested(flat, "online_ae")
    if ae:
        state["online_ae"] = online_ae_from_numpy(ae)
    if "torch_rng" in flat:
        state["torch_rng"] = torch.as_tensor(np.asarray(flat["torch_rng"]))
    ae_opt = _nested(flat, "torch_online_ae_opt")
    if ae_opt:
        state["torch_online_ae_opt"] = ae_opt
    return state

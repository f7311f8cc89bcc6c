"""Reference checkpoints to a checked weights directory: discover ->
convert -> parity (port of tools/verify_artifacts.py).

The day the reference's real checkpoints appear (`seg_clip_model_l.pth`,
the HR head's and the autoencoder's Lightning checkpoints, the online
autoencoder's state dict, LPIPS), this one command turns them into the
npz trees that `slam_torch.py --weights-dir OUT` and
`models.checkpoints.load_extractor_from_dir(OUT, ...)` read:

    python -m online_lang_splatting_tpu_torch.tools.verify_artifacts \
        --dir ART [--out OUT] [--skip-parity] [--device cuda]

1. **Discover**: every .pth / .ckpt / .pt under ART, loaded once on the
   CPU, classified by its state-dict keys (not its name) as `sed` (the
   CLIP towers, with or without SED's `sem_seg_head.predictor.clip_model.`
   prefix), `hr`, `ae`, `online_ae` or `lpips`; the first file of each
   kind is taken.
2. **Convert**: each model is built on the CPU at the sizes read off its
   checkpoint and loaded strictly (`visual.` is dropped for the visual
   tower, Lightning's `model.` for the HR head and the autoencoder); the
   checkpoint's own tensors, in their own dtype, are written by the port's
   converters (`convert.*_to_numpy`) as clip_visual.npz, clip_text.npz,
   hr_net.npz, autoencoder.npz and online_ae.npz, and LPIPS's as
   lpips_alex.npz with the flat keys `eval.lpips.load_params` reads.
3. **Parity**: (a) every npz read back (`convert.language_from_numpy`;
   LPIPS through `load_params`) gives the checkpoint's key set and every
   tensor bit for bit, dtype included (BatchNorm's `num_batches_tracked`,
   which no npz holds, aside); (b) one seeded forward of each model built
   from OUT on `--device` against the same model on the CPU built from the
   checkpoint, at the JAX tool's shapes and tolerances; each model's worst
   error is printed.

Exit code 0 when everything discovered converts and passes, 1 when
nothing is discovered, 2 naming the file and the key on a missing or
extra key, a strict load that fails or a parity miss. The report goes to
OUT/verify_report.json. Benchmarking on the converted weights waits for
the port's benchmark script.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

CLIP_PREFIXES = ("sem_seg_head.predictor.clip_model.", "")
# The CLIP text tower's top-level names; the CLIP model's other keys
# (logit_scale, an older open_clip's attn_mask) belong to no tower.
TEXT_ROOTS = ("token_embedding", "positional_embedding", "transformer", "ln_final",
              "text_projection")
NPZ = {"visual": "clip_visual.npz", "text": "clip_text.npz", "hr": "hr_net.npz",
       "ae": "autoencoder.npz", "online_ae": "online_ae.npz", "lpips": "lpips_alex.npz"}
# (b)'s bounds, the JAX tool's: (abs, rel) of the CPU model's output; the
# HR head's abs of its largest |value|; LPIPS relative (chip_smoke phase 7).
TOLS = {"visual": (5e-4, 1e-3), "text": (2e-4, 1e-3), "hr": (5e-4, 0.0), "ae": (2e-5, 1e-4),
        "online_ae": (2e-5, 1e-4), "lpips": (1e-5, 0.0)}


class VerifyError(Exception):
    """A checkpoint that does not convert or check; the message names the
    file and the key."""


class Part(NamedTuple):
    name: str               # a key of NPZ
    source: Path
    state: dict             # the checkpoint's tensors under the port's names
    model: object           # strictly loaded on the CPU (LPIPS: its params)
    ignored: tuple          # the file's keys no model takes


def _unwrap(obj):
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def classify(sd: dict) -> str | None:
    """The kind of a torch state dict, by its keys."""
    keys = set(sd)
    for pref in CLIP_PREFIXES:
        if pref + "visual.trunk.stem.0.weight" in keys:
            return "sed"
    plain = {k.removeprefix("model.") for k in keys}
    if "initial_conv.0.weight" in plain and "final_conv.weight" in plain:
        return "hr"
    if "encoder.0.weight" in plain and "decoder.0.weight" in plain:
        # The online AE: two Linears each way, no BatchNorm.
        has_bn = any(k.endswith("running_mean") for k in plain)
        return "ae" if has_bn else "online_ae"
    if "net.slice1.0.weight" in keys or "lin0.model.1.weight" in keys:
        return "lpips"
    return None


def discover(root: Path) -> dict:
    """{kind: (path, state dict)}: the first file of each kind under root,
    in path order, each loaded once on the CPU."""
    found: dict = {}
    for p in sorted(root.rglob("*")):
        if p.suffix not in (".pth", ".ckpt", ".pt") or not p.is_file():
            continue
        try:
            sd = _unwrap(torch.load(p, map_location="cpu", weights_only=False))
        except Exception as e:  # an unreadable or foreign pickle: reported, skipped
            print(f"  skip {p.name}: {type(e).__name__}: {e}")
            continue
        kind = classify(sd) if isinstance(sd, dict) else None
        if kind is None:
            print(f"  skip {p.name}: no known key signature")
        elif kind not in found:
            found[kind] = (p, sd)
            print(f"  {kind:<10} <- {p}")
    return found


def _infer_convnext_arch(sd: dict):
    """(depths, dims, embed) of a visual tower's keys (`visual.` dropped)."""
    dims, depths = [], []
    for s in range(4):
        d = 0
        while f"trunk.stages.{s}.blocks.{d}.conv_dw.weight" in sd:
            d += 1
        depths.append(d)
        dims.append(int(sd[f"trunk.stages.{s}.blocks.0.conv_dw.weight"].shape[0]))
    return tuple(depths), tuple(dims), int(sd["head.mlp.fc2.weight"].shape[0])


def _infer_text_arch(sd: dict) -> dict:
    """TextTower's keyword arguments off a text tower's keys; one head per
    64 channels, as the reference's towers have."""
    layers = 0
    while f"transformer.resblocks.{layers}.attn.in_proj_weight" in sd:
        layers += 1
    vocab, width = sd["token_embedding.weight"].shape
    return dict(vocab_size=int(vocab), context_length=int(sd["positional_embedding"].shape[0]),
                width=int(width), heads=int(width) // 64, layers=layers,
                embed_dim=int(sd["text_projection"].shape[1]))


def _infer_ae_dims(sd: dict):
    """(encoder dims, decoder dims, clip dim) of an autoencoder's keys."""
    enc, dec = [], []
    for idx in range(256):
        for part, dims in (("encoder", enc), ("decoder", dec)):
            w = sd.get(f"{part}.{idx}.weight")
            if w is not None and w.ndim == 2:
                dims.append(int(w.shape[0]))
    return tuple(enc), tuple(dec), int(sd["encoder.0.weight"].shape[1])


def _infer_hr_dims(sd: dict):
    """HighResLanguageFeatureNet's (in, res3, res2, out) channels; a fusion
    without `low_res_align` takes its skip at its own width."""
    def skip(i, width):
        w = sd.get(f"attention_fusion{i}.low_res_align.weight")
        return width if w is None else int(w.shape[1])

    return (int(sd["initial_conv.0.weight"].shape[1]), skip(1, 512), skip(2, 256),
            int(sd["final_conv.weight"].shape[0]))


def _strict(model, state: dict, source: Path, name: str):
    try:
        model.load_state_dict(state, strict=True)
    except RuntimeError as e:
        raise VerifyError(f"{source}: the {name} model does not load strictly: {e}") from None
    return model.eval().requires_grad_(False)


def _parts(kind: str, path: Path, sd: dict) -> list:
    """The models a checkpoint holds, each built on the CPU and strictly
    loaded from the checkpoint's tensors."""
    from ..models.autoencoder import AutoencoderMLP, EncoderDecoderOnline
    from ..models.convnext_clip import ConvNeXtCLIPVisual
    from ..models.hr_net import HighResLanguageFeatureNet
    from ..models.text_tower import TextTower

    if kind == "lpips":
        from ..eval import lpips

        state = {k: v for k, v in sd.items() if k.endswith(("weight", "bias"))}
        return [Part("lpips", path, state, lpips.params_from_state_dict(state, device="cpu"),
                     tuple(k for k in sd if k not in state))]
    if kind == "sed":
        pref = next(p for p in CLIP_PREFIXES if p + "visual.trunk.stem.0.weight" in sd)
        clip = {k.removeprefix(pref): v for k, v in sd.items() if k.startswith(pref)}
        visual = {k.removeprefix("visual."): v for k, v in clip.items()
                  if k.startswith("visual.")}
        text = {k: v for k, v in clip.items() if k.split(".")[0] in TEXT_ROOTS}
        taken = {pref + "visual." + k for k in visual} | {pref + k for k in text}
        ignored = tuple(k for k in sd if k not in taken)
        depths, dims, embed = _infer_convnext_arch(visual)
        return [Part("visual", path, visual,
                     _strict(ConvNeXtCLIPVisual(depths, dims, embed), visual, path, "visual"),
                     ignored),
                Part("text", path, text,
                     _strict(TextTower(**_infer_text_arch(text)), text, path, "text"), ())]
    if kind in ("hr", "ae"):
        state = {k.removeprefix("model."): v for k, v in sd.items()}
        if kind == "hr":
            model = HighResLanguageFeatureNet(*_infer_hr_dims(state))
        else:
            enc, dec, clip_dim = _infer_ae_dims(state)
            model = AutoencoderMLP(enc, dec, clip_dim)
        return [Part(kind, path, state, _strict(model, state, path, kind), ())]
    state = dict(sd)
    model = EncoderDecoderOnline(input_dim=int(state["encoder.0.weight"].shape[1]),
                                 compressed_dim=int(state["encoder.2.weight"].shape[0]),
                                 hidden=int(state["encoder.0.weight"].shape[0]))
    return [Part("online_ae", path, state, _strict(model, state, path, "online_ae"), ())]


def _write(part: Part, out: Path):
    from .. import convert
    from ..models.checkpoints import save_npz_tree

    path = out / NPZ[part.name]
    if part.name == "lpips":
        np.savez(path, **{k: convert._np(v) for k, v in part.state.items()})
        return
    if part.name == "text":
        tree = convert.text_to_numpy(part.state, _infer_text_arch(part.state)["heads"])
    else:
        tree = {"visual": convert.visual_to_numpy, "hr": convert.hr_to_numpy,
                "ae": convert.ae_to_numpy,
                "online_ae": convert.online_ae_to_numpy}[part.name](part.state)
    save_npz_tree(path, {"params": tree} if part.name == "online_ae" else tree)


def _carried(state: dict) -> dict:
    return {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}


def _read_back(part: Part, out: Path):
    """(a): the npz's tensors under the port's names, and the model (the
    CPU model's copy, or LPIPS's params) loaded from them."""
    from .. import convert
    from ..models.checkpoints import load_npz_tree

    path = out / NPZ[part.name]
    if part.name == "lpips":
        from ..eval import lpips

        with np.load(path) as flat:
            back = {k: torch.from_numpy(flat[k]) for k in flat.files}
        return back, lpips.load_params(str(path), device="cpu")
    tree = load_npz_tree(path)
    if part.name == "online_ae":
        tree = tree["params"]
    if part.name == "text":
        config = convert.text_config(tree)
        if config != _infer_text_arch(part.state):
            raise VerifyError(f"{path}: text tower {config} read back, "
                              f"{_infer_text_arch(part.state)} converted")
    back = convert.language_from_numpy(**{part.name: tree})[part.name]
    return back, _strict(copy.deepcopy(part.model), back, path, part.name)


def _check_round_trip(part: Part, back: dict):
    want, got = _carried(part.state), _carried(back)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise VerifyError(f"{part.source} -> {NPZ[part.name]}: keys missing {missing}, "
                          f"extra {extra}")
    for k, v in want.items():
        if got[k].dtype != v.dtype or not torch.equal(got[k], v.detach().cpu()):
            raise VerifyError(f"{part.source} -> {NPZ[part.name]}: {k} differs "
                              f"({v.dtype} -> {got[k].dtype})")


def _inputs(part: Part, model):
    """The JAX tool's seeded inputs of one model (LPIPS: two 64^2 images)."""
    if part.name == "visual":
        x = np.random.default_rng(0).normal(size=(1, 3, 64, 64))
        return (torch.from_numpy(x.astype(np.float32)),)
    if part.name == "text":
        vocab, ctx = model.token_embedding.weight.shape[0], model.positional_embedding.shape[0]
        tokens = np.zeros((2, ctx), np.int64)
        tokens[0, :5] = [1, 100, min(2000, vocab - 2), min(30000, vocab - 2), vocab - 1]
        tokens[1, :3] = [1, 400, vocab - 1]
        return (torch.from_numpy(tokens % vocab),)
    if part.name == "hr":
        g = np.random.default_rng(1)
        c_in, c3, c2, _ = _infer_hr_dims(part.state)
        return tuple(torch.from_numpy(g.normal(size=s).astype(np.float32))
                     for s in ((1, c_in, 6, 6), (1, c3, 24, 24), (1, c2, 48, 48)))
    if part.name == "ae":
        x = np.random.default_rng(2).normal(size=(32, model.encoder[0].in_features))
        return (torch.from_numpy(x.astype(np.float32)),)
    if part.name == "online_ae":
        x = np.random.default_rng(3).normal(size=(16, model.encoder[0].in_features))
        return (torch.from_numpy(x.astype(np.float32)),)
    g = np.random.default_rng(4)
    return tuple(torch.from_numpy(g.uniform(size=(1, 3, 64, 64)).astype(np.float32))
                 for _ in range(2))


def _forward(part: Part, model, xs):
    """A model's outputs as {name: tensor} on the CPU."""
    if part.name == "lpips":
        from ..eval import lpips

        return {"lpips": lpips.lpips(model, *xs).reshape(1).cpu()}
    if part.name == "online_ae":
        out = model.encode(*xs)
    else:
        out = model(*xs)
    if isinstance(out, dict):
        return {k: v.cpu() for k, v in out.items()}
    return {"out": out.cpu()}


def _to(model, device):
    if isinstance(model, dict):  # LPIPS's params
        return {"convs": [(w.to(device), b.to(device)) for w, b in model["convs"]],
                "lins": [w.to(device) for w in model["lins"]]}
    return model.to(device)


def _check_forward(part: Part, model_out, device) -> dict:
    """(b): the model built from OUT on `device` against the checkpoint's
    model on the CPU, on the same seeded inputs."""
    xs = _inputs(part, part.model)
    with torch.no_grad():
        ref = _forward(part, part.model, xs)
        got = _forward(part, _to(model_out, device), tuple(x.to(device) for x in xs))
    atol, rtol = TOLS[part.name]
    report = {"tol_abs": atol, "tol_rel": rtol, "outputs": {}}
    for key, r in ref.items():
        r, g = r.double(), got[key].double()
        # The HR head's error relative to its largest |value| (the JAX
        # tool's), LPIPS's to max(|value|, 1) (chip_smoke phase 7's).
        scale = {"hr": float(r.abs().max()),
                 "lpips": max(float(r.abs().max()), 1.0)}.get(part.name, 1.0)
        r, g = r / scale, g / scale
        err = (g - r).abs()
        excess = float((err - atol - rtol * r.abs()).max())
        report["outputs"][key] = {"max_abs_err": float(err.max()), "excess": excess}
        if not (excess <= 0 and torch.isfinite(g).all()):
            raise VerifyError(f"{part.source} -> {NPZ[part.name]}: {part.name} output {key} "
                              f"on {device} misses the CPU model's by {float(err.max()):.3e} "
                              f"(abs {atol}, rel {rtol})")
    report["max_abs_err"] = max(v["max_abs_err"] for v in report["outputs"].values())
    return report


def verify(root: Path, out: Path, device, parity: bool = True) -> dict:
    """The three steps; raises VerifyError. Returns the report (None when
    nothing was discovered)."""
    t0 = time.time()
    print(f"[1/3] discovering artifacts under {root}")
    found = discover(root)
    if not found:
        return None
    report: dict = {"found": {k: str(p) for k, (p, _) in found.items()},
                    "discover_s": time.time() - t0, "models": {}}
    t0 = time.time()
    print(f"[2/3] converting into {out}")
    out.mkdir(parents=True, exist_ok=True)
    parts = []
    for kind, (path, sd) in found.items():
        try:
            made = _parts(kind, path, sd)
        except KeyError as e:
            raise VerifyError(f"{path}: {kind} checkpoint lacks the key {e}") from None
        for part in made:
            _write(part, out)
            report["models"][part.name] = {"file": str(path), "npz": NPZ[part.name],
                                          "tensors": len(part.state)}
            if part.ignored:
                print(f"  {part.source.name}: {len(part.ignored)} keys outside the models, "
                      f"e.g. {list(part.ignored)[:4]}")
            print(f"  wrote {NPZ[part.name]} ({len(part.state)} tensors of "
                  f"{part.source.name})")
            parts.append(part)
    report["convert_s"] = time.time() - t0
    t0 = time.time()
    if not parity:
        print("[3/3] parity skipped (--skip-parity)")
        return report
    print(f"[3/3] parity: the npz read back, and each model from {out} on {device} "
          f"against the checkpoint's on the CPU")
    for part in parts:
        back, model_out = _read_back(part, out)
        _check_round_trip(part, back)
        res = _check_forward(part, model_out, device)
        report["models"][part.name].update(res, round_trip="bit for bit")
        print(f"  {part.name:<10} {NPZ[part.name]}: {len(_carried(part.state))} tensors bit "
              f"for bit; forward worst abs error {res['max_abs_err']:.3e} (abs "
              f"{res['tol_abs']}, rel {res['tol_rel']})")
    report["parity_s"] = time.time() - t0
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", required=True, help="directory holding the torch checkpoints")
    ap.add_argument("--out", default=None,
                    help="output directory of the npz trees (default <dir>/converted)")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import entry_device

    device = entry_device(args.device)
    root = Path(args.dir)
    out = Path(args.out) if args.out else root / "converted"
    try:
        report = verify(root, out, device, parity=not args.skip_parity)
    except VerifyError as e:
        print(f"FAILED: {e}")
        return 2
    if report is None:
        print("no recognizable artifacts found")
        return 1
    report["device"] = str(device)
    (out / "verify_report.json").write_text(json.dumps(report, indent=1))
    print("ALL OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Loading converted checkpoints and the online autoencoder trainer (port
of models/checkpoints.py)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .autoencoder import (ONE_STAGE_DEC, ONE_STAGE_ENC, TWO_STAGE_DEC,
                          TWO_STAGE_ENC, EncoderDecoderOnline,
                          make_online_optimizer, online_train_step)
from .init import make_generator


def load_npz_tree(path) -> dict:
    """A tools/convert_weights.py npz ('a/b/c' keys) -> nested numpy dict."""
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree


def save_npz_tree(path, tree: dict):
    """A nested numpy dict -> an npz with 'a/b/c' keys (the layout
    tools/convert_weights.py writes and `load_npz_tree` reads)."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    rec("", tree)
    np.savez(path, **flat)


def load_text_tower(path, device="cuda"):
    """The CLIP text tower from a clip_text.npz tree, its size read off
    the tree."""
    from ..convert import text_config, text_from_numpy
    from .text_tower import TextTower

    tree = load_npz_tree(path)
    tower = TextTower(**text_config(tree))
    tower.load_state_dict(text_from_numpy(tree))
    return tower.to(device).eval().requires_grad_(False)


def load_extractor_from_dir(weights_dir, config, device="cuda"):
    """Build the fused language extractor (+ the online AE trainer in
    two-stage mode) from a directory of tools/convert_weights.py outputs.
    A missing file falls back to random init with a warning, so the
    pipeline stays runnable end to end."""
    from ..convert import language_from_numpy
    from .sed import LangFeatureExtractor

    lang_cfg = config.get("language", {})
    single_stage = lang_cfg.get("single_stage", True)
    trees = {}
    if weights_dir:
        d = Path(weights_dir)
        for key, name in (("visual", "clip_visual"), ("hr", "hr_net"),
                          ("ae", "autoencoder")):
            p = d / f"{name}.npz"
            if p.exists():
                trees[key] = load_npz_tree(p)
            else:
                print(f"[checkpoints] {name}.npz not found in {d}; using random init")
    else:
        print("[checkpoints] no --weights-dir; language models random-init")
    states = language_from_numpy(**trees)
    extractor = LangFeatureExtractor(
        states.get("visual"), states.get("hr"), states.get("ae"),
        encoder_dims=ONE_STAGE_ENC if single_stage else TWO_STAGE_ENC,
        decoder_dims=ONE_STAGE_DEC if single_stage else TWO_STAGE_DEC,
        use_hr=lang_cfg.get("hr_model", True), device=device)
    online_ae = None if single_stage else OnlineAETrainer(device=device)
    return extractor, online_ae


class OnlineAETrainer:
    """Two-stage online 32 -> 15 compressor trained during SLAM, with the
    reference's cadence: one step (l1 + 0.6 (1 - cos), Adam 1e-3) on a
    keyframe's cached 32-d codes at each new-keyframe extraction, every
    5th init iteration, and at every random anti-forgetting keyframe visit
    in mapping (the backend calls `train_rows` with the visited keyframes
    in order)."""

    def __init__(self, device="cuda"):
        self.model = EncoderDecoderOnline(generator=make_generator(0)).to(device)
        self.optimizer = make_online_optimizer(self.model)
        self.step_count = 0
        self.loss_history = []  # device scalars, one per gradient step

    def _step(self, codes32):
        loss = online_train_step(self.model, self.optimizer, codes32)
        self.step_count += 1
        self.loss_history.append(loss)
        return loss

    def train_and_encode(self, codes32: torch.Tensor) -> torch.Tensor:
        self._step(codes32)
        with torch.no_grad():
            return self.model.encode(codes32)

    def train_rows(self, rows, cocos):
        """One gradient step per entry of `rows`, in order, on `cocos[r]`
        ((N, 32) codes; `cocos` maps keyframe ids to them). Returns the
        per-step losses."""
        return [self._step(cocos[r]) for r in rows]

    @torch.no_grad()
    def decode(self, codes15: torch.Tensor) -> torch.Tensor:
        return self.model.decode(codes15)

"""YAML configuration with recursive `inherit_from` merging (a copy of
slam/config.py of the JAX package, which the port cannot import)."""

from __future__ import annotations

from pathlib import Path

import yaml


def _deep_update(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str | Path) -> dict:
    path = Path(path)
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    parent = cfg.pop("inherit_from", None)
    if parent:
        parent_path = Path(parent)
        if not parent_path.is_absolute():
            # Paths are relative to the working directory; fall back to the
            # child's directory.
            cand = path.parent / parent_path.name
            parent_path = parent_path if parent_path.exists() else cand
        cfg = _deep_update(load_config(parent_path), cfg)
    return cfg

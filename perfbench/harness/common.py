"""What every cell shares: the manifest and the files it names, the result
line, the check's numbers against their limits, the card's description,
and the rule that the JAX package never loads."""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# Top-level module names that must not be loaded in a run's process: the
# JAX package (which the port's name begins with, so names are compared
# whole) and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "online_lang_splatting_tpu")


class StopWindow(Exception):
    """Raised at the frame boundary that closes a SLAM window."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(man: dict, workload: str) -> dict:
    """The workload's entry with its configuration and traffic files read,
    and the metrics it reports: {"workload", "config", "traffic",
    "limits", "end_to_end": [...], "per_layer": [...]}."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return dict(workload=w, config=load_json(ROOT / conf["file"]),
                traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH_DIR / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    """`read(ctx)` of perfbench/metrics/<name>.py."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(metrics: list, ctx: dict) -> dict:
    """Each per-layer metric's reader on the run's context; a reader that
    finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number compared beside its limit; correct when every number is
    finite and at most its limit. A number the run could not read (None)
    is left out."""
    check = {}
    ok = True
    for name, value in numbers.items():
        if value is None:
            continue
        limit = limits[name]
        check[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok and bool(check), check


def rel_mean_abs(a, b) -> float:
    """Mean |a - b| over the reference b's mean |b|."""
    num = float((a.float() - b.float()).abs().mean())
    den = float(b.float().abs().mean())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def rel_fro(a, b) -> float:
    """Frobenius norm of a - b over the reference b's."""
    num = float((a.float() - b.float()).norm())
    den = float(b.float().norm())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, count: int, peak: int) -> dict:
    """`peak`: the fullest card's peak allocation, read as the window
    closed (the references run after it on the same card)."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def smi() -> str:
    """The card's name, power limit, clocks, power draw and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem,power.draw,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                check: dict, breakdown: dict | None = None) -> str:
    """The last line of standard output; the compared numbers come last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = check
    return json.dumps(out)


def print_check(check: dict, stream=sys.stderr):
    for name, c in check.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=stream)
    stream.flush()

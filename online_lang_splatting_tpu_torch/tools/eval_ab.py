"""Phase 7 of chip_smoke.py from two checkouts on one card, in turns.

    python -m online_lang_splatting_tpu_torch.tools.eval_ab --other DIR [--turns 4]

DIR is another checkout of the repository (an earlier commit unpacked with
`git archive`, say). Each turn is a process of its own in one checkout's
root: it builds that checkout's kernels (chip_smoke.phase1_build), then
runs its chip_smoke.phase7_disk_entry on the default config (slam_torch.py
--eval on recorded Replica-v2 frames, the resume, threaded mode, LPIPS)
and reports the --eval run's wall, FPS and phase times, the host's decode
and camera medians (code neither tree's kernels run) and the threaded
FPS. Turns alternate other, this, this, other, ... so that a drift of the
host over the call falls on both sides.

Prints the card's name and power limit, one JSON line per turn, then the
means per checkout, and returns the turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
_TAG = "EVAL_AB "
_CHILD = """
import json, sys, tempfile
from pathlib import Path
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase1_build()
with tempfile.TemporaryDirectory() as work:
    out, _slam, _cfg = cs.phase7_disk_entry(
        str(cs.REPO / "configs/synthetic/replica_scale.yaml"), torch.device("cuda:0"),
        Path(work))
keys = ("eval_run_s", "fps", "phase_times", "decode_ms_median", "camera_ms_median",
        "threaded_fps", "refine_ms_per_iter", "wall_s")
print(%r + json.dumps({k: out[k] for k in keys}, default=float))
""" % _TAG


def run_turn(root: Path) -> dict:
    """One process in `root` running its phase 7; its numbers."""
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=root, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 7 in {root} exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith(_TAG)][-1]
    return json.loads(line[len(_TAG):])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="another checkout's root")
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[eval_ab] card {smi.strip()}")
    roots = {"other": Path(args.other).resolve(), "this": REPO}
    order = ["other", "this", "this", "other"]
    turns = []
    for i in range(args.turns):
        side = order[i % 4]
        row = dict(turn=i, side=side, **run_turn(roots[side]))
        print(json.dumps(row), flush=True)
        turns.append(row)
    for side in roots:
        rows = [r for r in turns if r["side"] == side]
        if rows:
            mean = {k: sum(r[k] for r in rows) / len(rows)
                    for k in ("eval_run_s", "fps", "decode_ms_median", "threaded_fps",
                              "refine_ms_per_iter")}
            print(f"[eval_ab] {side} ({roots[side]}), mean of {len(rows)}: "
                  + json.dumps(mean))
    return turns


if __name__ == "__main__":
    main()

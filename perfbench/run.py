#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. It builds the cell's system from the seed, opens the window,
measures for `--seconds`, checks what the window produced against the
benchmark's plain references, and prints as its last line of standard
output one JSON object (correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and last the compared numbers beside their limits),
which it also prints on the last lines of standard error. With --trace 0
the metrics are the cell's end-to-end metrics; with --trace 1 its
per-layer metrics, read from a `torch.profiler` trace of the window and
the program's counters. It exits non-zero and prints no result when the
card is missing, or when the JAX package or JAX is loaded in its process.
`--control tf32` runs the program with TF32 on (the precision below the
configuration's float32), for the check's control; the benchmark's own
runs never pass it."""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    args = ap.parse_args(argv)

    from perfbench.harness import common

    cell = common.cell(common.manifest(), args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    kind = cell["config"]["system"]
    if kind == "slam":
        from perfbench.harness import slam_cell as system
    elif kind == "extractor":
        from perfbench.harness import stream_cell as system
    else:
        raise SystemExit(f"unknown system {kind!r}")
    seed = args.seed % (1 << 63)
    out = system.run(cell, seed, args.seconds, bool(args.trace), T_START, control=args.control)
    correct, check = common.judge(out["numbers"], cell["limits"])
    correct = correct and out["failed"] == 0
    device = common.device_info(torch, chips, out["peak"])
    print(f"perfbench: {args.workload} seed {args.seed} trace {args.trace} control "
          f"{args.control}: {out['frames']} frames in {out['window_s']:.4f} s; card "
          f"{common.smi()}")
    ctx = out["ctx"]
    print("perfbench: context " + json.dumps(
        {k: v for k, v in ctx.items() if isinstance(v, (int, float, str, dict))}))
    print("perfbench: detail " + json.dumps(out.get("detail")))
    breakdown = None
    if args.trace:
        metrics = common.read_per_layer(cell["per_layer"], ctx)
        tr = ctx["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.gaps(ctx["spans"])}
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    found = common.forbidden_loaded()
    if found:
        print(f"perfbench: modules that must not load are loaded: {found}", file=sys.stderr)
        return 3
    print(common.result_line(correct=correct, attempted=out["attempted"], failed=out["failed"],
                             metrics=metrics, device=device, check=check, breakdown=breakdown),
          flush=True)
    common.print_check(check)
    return 0


if __name__ == "__main__":
    sys.exit(main())

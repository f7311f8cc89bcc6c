"""The HR head's 2x upsample two ways, on the card.

    python -m online_lang_splatting_tpu_torch.tools.upsample_ab [--seed 0] [--runs 20]

The head runs its three ConvTranspose2d(k=4, s=2, p=1) upsamples in the
polyphase form (models/hr_net.py:PhaseConvTranspose2d: four 2x2 forward
convolutions, the same parameters). The other form is cuDNN's transposed
convolution with `cudnn.deterministic` set for that call alone and put
back after it. On one seeded head and seeded inputs at the extractor's
shapes (float32, TF32 off, no autograd, as the extractor runs it), for
the whole head and each upsample alone:

- each form's output 10 times, bit-equal to its first or not; cuDNN's
  transposed convolution without the flag is checked the same way;
- the two forms against each other (max abs);
- the median of `runs` calls (CUDA events, one call at a time), turns
  polyphase, scoped, scoped, polyphase.

Prints the card's name and power limit, then one JSON line, and returns it.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
from torch import nn

from ..models.hr_net import HighResLanguageFeatureNet, PhaseConvTranspose2d
from ..models.init import make_generator


class ScopedDeterministicConvTranspose2d(nn.ConvTranspose2d):
    """cuDNN's transposed convolution with `cudnn.deterministic` set for
    this call alone (a process-wide flag, put back after the call)."""

    def forward(self, x):
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return super().forward(x)
        finally:
            torch.backends.cudnn.deterministic = prev


FORMS = {"polyphase": PhaseConvTranspose2d,
         "scoped_deterministic": ScopedDeterministicConvTranspose2d,
         "cudnn": nn.ConvTranspose2d}


def _time(fn, runs: int) -> float:
    fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[upsample_ab] card {smi.strip()}")
    net = HighResLanguageFeatureNet(generator=make_generator(args.seed)).to(dev).eval()
    rng = np.random.default_rng(args.seed)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

    head_in = (t(1, 768, 24, 24), t(1, 384, 96, 96), t(1, 192, 192, 192))
    ups = {"upsample1": (net.upsample1[0], t(1, 512, 24, 24)),
           "upsample2": (net.upsample2[0], t(1, 512, 48, 48)),
           "upsample3": (net.upsample3[0], t(1, 256, 96, 96))}
    cases = {"head": lambda: net(*head_in),
             **{name: (lambda m=m, x=x: m(x)) for name, (m, x) in ups.items()}}

    def use(form: str):
        for m, _ in ups.values():
            m.__class__ = FORMS[form]

    out: dict = {"card": smi.strip(), "seed": args.seed, "runs": args.runs}
    with torch.no_grad():
        for name, fn in cases.items():
            row: dict = {"repeats": {}}
            first = {}
            for form in FORMS:
                use(form)
                first[form] = fn()
                row["repeats"][form] = all(torch.equal(first[form], fn()) for _ in range(9))
            row["max_abs_scoped_vs_polyphase"] = float(
                (first["scoped_deterministic"] - first["polyphase"]).abs().max())
            turns = []
            for form in ("polyphase", "scoped_deterministic", "scoped_deterministic",
                         "polyphase"):
                use(form)
                turns.append(_time(fn, args.runs))
            row.update(polyphase_ms=(turns[0] + turns[3]) / 2,
                       scoped_ms=(turns[1] + turns[2]) / 2, turns_ms=turns)
            out[name] = row
    use("polyphase")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

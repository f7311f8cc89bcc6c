"""LPIPS perceptual distance, AlexNet variant (port of eval/lpips.py).

  d(x, y) = sum_l mean_hw w_l . || f_l(x)^ - f_l(y)^ ||^2

with f_l the post-ReLU activations of the five AlexNet conv stages,
unit-normalised over channels (^), and w_l >= 0 LPIPS's 1x1 "lin" weights.
Inputs are RGB in [0, 1]; LPIPS's shift / scale of [-1, 1] inputs is
applied here. The convolutions are plain PyTorch (cuDNN on the card), as
the JAX package runs them in XLA.

Parameters: {"convs": [(weight (O, I, k, k), bias (O,)) x 5],
"lins": [(1, C, 1, 1) x 5]}, from `init_params` (seeded random), a torch
state_dict (`params_from_state_dict`) or the npz of
`tools/convert_weights.py --lpips` (`load_params`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

# torchvision AlexNet `features` convs: (out, in, kernel, stride, pad).
_CONVS = (
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
)
# MaxPool(3, stride 2) comes before convs 1 and 2; LPIPS taps each ReLU.
_POOL_BEFORE = (False, True, True, False, False)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _tree(convs, lins, device) -> Dict:
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {"convs": [(t(w), t(b)) for w, b in convs], "lins": [t(w) for w in lins]}


def init_params(rng: np.random.Generator | None = None, device="cuda") -> Dict:
    """Seeded random parameters: the JAX package's draws, in its order."""
    rng = rng or np.random.default_rng(0)
    convs = []
    for (o, i, k, _s, _p) in _CONVS:
        w = rng.normal(size=(o, i, k, k)).astype(np.float32) * 0.05
        b = rng.normal(size=(o,)).astype(np.float32) * 0.05
        convs.append((w, b))
    lins = [np.abs(rng.normal(size=(1, o, 1, 1))).astype(np.float32)
            for (o, *_rest) in _CONVS]
    return _tree(convs, lins, device)


def params_from_state_dict(sd: Dict, device="cuda") -> Dict:
    """The `lpips` package layout (`net.slice{k}.{i}.weight`,
    `lin{k}.model.1.weight`) or torchvision's (`features.{i}.weight`,
    `lin{k}.weight`)."""
    sd = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}

    def find(*names):
        for n in names:
            if n in sd:
                return sd[n]
        raise KeyError(names)

    convs = []
    for k, fi in enumerate((0, 3, 6, 8, 10)):  # conv positions in `features`
        convs.append((find(f"net.slice{k + 1}.{fi}.weight", f"features.{fi}.weight"),
                      find(f"net.slice{k + 1}.{fi}.bias", f"features.{fi}.bias")))
    lins = [find(f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight", f"lin{k}.weight")
            for k in range(5)]
    return _tree(convs, lins, device)


def load_params(npz_path: str, device="cuda") -> Dict:
    with np.load(npz_path) as data:
        return params_from_state_dict({k: data[k] for k in data.files}, device)


def _alexnet_feats(params: Dict, x: torch.Tensor) -> list:
    feats = []
    for (w, b), (_o, _i, _k, s, p), pool in zip(params["convs"], _CONVS, _POOL_BEFORE):
        if pool:
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(F.conv2d(x, w, b, stride=s, padding=p))
        feats.append(x)
    return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


@torch.no_grad()
def lpips(params: Dict, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """LPIPS between (3, H, W) or (N, 3, H, W) RGB images in [0, 1]."""
    if img0.dim() == 3:
        img0, img1 = img0[None], img1[None]
    dev = img0.device
    shift = torch.as_tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=dev)[None, :, None, None]

    def prep(x):
        return (2.0 * x - 1.0 - shift) / scale

    total = 0.0
    for a, b, w in zip(_alexnet_feats(params, prep(img0)), _alexnet_feats(params, prep(img1)),
                       params["lins"]):
        diff = torch.square(_unit_normalize(a) - _unit_normalize(b))
        # The 1x1 non-negative "lin" conv is a channel-weighted sum.
        total = total + torch.mean(torch.sum(diff * w, dim=1), dim=(1, 2))
    return total[0] if total.shape == (1,) else total


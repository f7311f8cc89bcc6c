"""Carry state into the port from numpy.

The input is the JAX package's state with every field already converted to
numpy by the caller (the port never imports JAX), so both packages can
start a tracking run or a mapping iteration from the same map.
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

"""Gaussian map: fixed-capacity SoA + masked Adam + densification (port of
models/gaussians.py).

The map lives in fixed-capacity tensors with an active mask, exactly as
in the JAX package, so tests compare state slot by slot. Structural edits
allocate free slots (`_alloc_slots`), pruning clears mask bits, and every
(re)allocated slot gets zero Adam moments. Functions return new tensors
rather than editing their inputs, like the reference.

Random draws are inputs: the split noise of `densify_and_prune` comes
from a `torch.Generator` or is injected by the caller.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import sh as sh_ops
from ..ops.knn import knn_mean_sq_dist
from ..ops.raster.preprocess import quat_to_rotmat
from ..utils.profiling import span


class GaussianParams(NamedTuple):
    """Raw (pre-activation) parameters; leaves shaped (cap, ...)."""

    xyz: torch.Tensor            # (N, 3)
    features_dc: torch.Tensor    # (N, 1, 3)
    features_rest: torch.Tensor  # (N, K-1, 3)
    scaling: torch.Tensor        # (N, 3) log-scale
    rotation: torch.Tensor       # (N, 4) unnormalized quaternion
    opacity: torch.Tensor        # (N, 1) logit
    language: torch.Tensor       # (N, L)


class GaussianAux(NamedTuple):
    active: torch.Tensor          # (N,) bool
    max_radii2d: torch.Tensor     # (N,) f32
    xyz_grad_accum: torch.Tensor  # (N,) f32
    denom: torch.Tensor           # (N,) f32
    kf_id: torch.Tensor           # (N,) int32
    n_obs: torch.Tensor           # (N,) int32


class AdamState(NamedTuple):
    mu: GaussianParams
    nu: GaussianParams
    count: torch.Tensor  # () int32


class LearningRates(NamedTuple):
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    language: torch.Tensor


def _map(fn, *trees):
    return type(trees[0])(*(fn(*leaves) for leaves in zip(*trees)))


# ---------------------------------------------------------------------------
# Construction


def empty_params(capacity: int, sh_degree: int, lang_dim: int,
                 device=None) -> GaussianParams:
    k = (sh_degree + 1) ** 2
    f32 = dict(dtype=torch.float32, device=device)
    rotation = torch.zeros((capacity, 4), **f32)
    rotation[:, 0] = 1.0
    return GaussianParams(
        xyz=torch.zeros((capacity, 3), **f32),
        features_dc=torch.zeros((capacity, 1, 3), **f32),
        features_rest=torch.zeros((capacity, k - 1, 3), **f32),
        scaling=torch.zeros((capacity, 3), **f32),
        rotation=rotation,
        opacity=torch.full((capacity, 1), -9.21, **f32),
        language=torch.zeros((capacity, lang_dim), **f32),
    )


def empty_aux(capacity: int, device=None) -> GaussianAux:
    return GaussianAux(
        active=torch.zeros(capacity, dtype=torch.bool, device=device),
        max_radii2d=torch.zeros(capacity, dtype=torch.float32, device=device),
        xyz_grad_accum=torch.zeros(capacity, dtype=torch.float32, device=device),
        denom=torch.zeros(capacity, dtype=torch.float32, device=device),
        kf_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        n_obs=torch.zeros(capacity, dtype=torch.int32, device=device),
    )


def init_adam(params: GaussianParams) -> AdamState:
    zeros = _map(torch.zeros_like, params)
    return AdamState(mu=zeros, nu=_map(torch.zeros_like, params),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=params.xyz.device))


# ---------------------------------------------------------------------------
# Activations


def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_rotation(p: GaussianParams) -> torch.Tensor:
    return p.rotation / torch.linalg.norm(p.rotation, dim=-1, keepdim=True)


def inverse_sigmoid(x):
    return math.log(x / (1.0 - x))


# ---------------------------------------------------------------------------
# Adam with per-group LRs


def adam_step(params: GaussianParams, grads: GaussianParams, state: AdamState,
              lrs: LearningRates, active: torch.Tensor, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-15):
    """One masked Adam step. Inactive slots are frozen entirely."""
    count = state.count + 1
    cf = count.to(torch.float32)
    with span("sync.adam.beta"):
        beta1 = torch.tensor(b1, dtype=torch.float32, device=cf.device)
    with span("sync.adam.beta"):
        beta2 = torch.tensor(b2, dtype=torch.float32, device=cf.device)
    c1 = 1.0 - torch.pow(beta1, cf)
    c2 = 1.0 - torch.pow(beta2, cf)

    ps, mus, nus = [], [], []
    for p, g, mu, nu, lr in zip(params, grads, state.mu, state.nu, lrs):
        mask = active.reshape((-1,) + (1,) * (p.dim() - 1))
        g = torch.where(mask, g, torch.zeros_like(g))
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        step = lr * (mu / c1) / (torch.sqrt(nu / c2) + eps)
        ps.append(torch.where(mask, p - step, p))
        mus.append(mu)
        nus.append(nu)
    return GaussianParams(*ps), AdamState(
        mu=GaussianParams(*mus), nu=GaussianParams(*nus), count=count)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1000000) -> torch.Tensor:
    """Log-linear LR interpolation with optional delayed warmup, in float32
    like the reference."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(
        torch.log(torch.tensor(lr_init, dtype=f32)) * (1 - t)
        + torch.log(torch.tensor(lr_final, dtype=f32)) * t)
    return delay_rate * log_lerp


# ---------------------------------------------------------------------------
# Structural edits


def _alloc_slots(active: torch.Tensor, want: torch.Tensor, max_new: int):
    """Assign up to max_new free slots to the `want` candidates. Returns
    (slot index (M,) int64, ok (M,) bool); not-ok rows carry `capacity`."""
    cap = active.shape[0]
    with span("sync.gaussians.alloc"):
        free = torch.nonzero(~active).flatten()[:max_new]
    free_idx = torch.full((max_new,), cap, dtype=torch.int64, device=active.device)
    free_idx[:free.shape[0]] = free
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    slot = free_idx[torch.clamp(rank, 0, max_new - 1)]
    ok = want & (rank < max_new) & (slot < cap)
    return torch.where(ok, slot, torch.full_like(slot, cap)), ok


def _scatter_rows(dst: torch.Tensor, src: torch.Tensor, slots, ok) -> torch.Tensor:
    out = dst.clone()
    with span("sync.gaussians.scatter"):
        to = slots[ok]
    with span("sync.gaussians.scatter"):
        out[to] = src[ok]
    return out


def _scatter_value(dst: torch.Tensor, slots, ok, value) -> torch.Tensor:
    out = dst.clone()
    with span("sync.gaussians.scatter"):
        to = slots[ok]
    with span("sync.gaussians.scatter"):  # the value's upload
        out[to] = value
    return out


def _zero_moments(state: AdamState, slots, ok) -> AdamState:
    def z(m):
        return _scatter_value(m, slots, ok, 0.0)

    return AdamState(mu=_map(z, state.mu), nu=_map(z, state.nu), count=state.count)


def extend_points(params: GaussianParams, aux: GaussianAux, opt: AdamState, *,
                  xyz, rgb, valid, kf_id: int, point_size: float = 1.0,
                  init_opacity: float = 0.5):
    """Keyframe extension: back-projected points become fresh Gaussians
    (SH-DC from RGB, scale from the 3-NN mean squared distance, identity
    rotation, opacity 0.5, zero language code)."""
    m = xyz.shape[0]
    dev = xyz.device
    dist2 = torch.clamp(knn_mean_sq_dist(xyz, valid), min=1e-7) * point_size
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    rotation = torch.zeros((m, 4), dtype=torch.float32, device=dev)
    rotation[:, 0] = 1.0
    new = GaussianParams(
        xyz=xyz,
        features_dc=sh_ops.rgb_to_sh(rgb)[:, None, :],
        features_rest=torch.zeros((m,) + tuple(params.features_rest.shape[1:]),
                                  dtype=torch.float32, device=dev),
        scaling=log_scale,
        rotation=rotation,
        opacity=torch.full((m, 1), inverse_sigmoid(init_opacity),
                           dtype=torch.float32, device=dev),
        language=torch.zeros((m, params.language.shape[1]),
                             dtype=torch.float32, device=dev),
    )
    slots, ok = _alloc_slots(aux.active, valid, m)
    params = _map(lambda d, s: _scatter_rows(d, s, slots, ok), params, new)
    opt = _zero_moments(opt, slots, ok)
    aux = aux._replace(
        active=_scatter_value(aux.active, slots, ok, True),
        kf_id=_scatter_value(aux.kf_id, slots, ok, int(kf_id)),
        n_obs=_scatter_value(aux.n_obs, slots, ok, 0),
        max_radii2d=_scatter_value(aux.max_radii2d, slots, ok, 0.0),
        xyz_grad_accum=_scatter_value(aux.xyz_grad_accum, slots, ok, 0.0),
        denom=_scatter_value(aux.denom, slots, ok, 0.0),
    )
    with span("sync.kf.extend"):
        overflow = bool(valid.sum() > ok.sum())
    return params, aux, opt, overflow


def split_noise(generator: torch.Generator, shape, device) -> tuple:
    """The two standard-normal draws of a split, from `generator`."""
    return tuple(
        torch.randn(shape, generator=generator, device=device) for _ in range(2))


def densify_and_prune(params: GaussianParams, aux: GaussianAux, opt: AdamState,
                      noise: tuple, *, max_grad: float, min_opacity: float,
                      extent: float, max_screen_size: int | None,
                      percent_dense: float = 0.01, max_new: int = 8192):
    """Clone + split + prune (reference densify_and_prune). `noise` is the
    pair of (cap, 3) standard-normal draws for the two split samples."""
    grads = aux.xyz_grad_accum / torch.clamp(aux.denom, min=1e-12)
    grads = torch.where(torch.isnan(grads) | ~aux.active,
                        torch.zeros_like(grads), grads)
    scal = get_scaling(params)
    max_scale = torch.amax(scal, dim=1)

    # Clone: candidate i is Gaussian i itself, copied into a new slot.
    clone_mask = (grads >= max_grad) & (max_scale <= percent_dense * extent) & aux.active
    slots, ok = _alloc_slots(aux.active, clone_mask, max_new)
    params = _map(lambda d: _scatter_rows(d, d, slots, ok), params)
    opt = _zero_moments(opt, slots, ok)
    aux = aux._replace(
        active=_scatter_value(aux.active, slots, ok, True),
        kf_id=_scatter_rows(aux.kf_id, aux.kf_id, slots, ok),
        n_obs=_scatter_rows(aux.n_obs, aux.n_obs, slots, ok),
    )

    # Split (N=2): one sample replaces the original in place, one goes to a
    # fresh slot; both get sampled offsets and scales / (0.8·2).
    split_mask = (grads >= max_grad) & (max_scale > percent_dense * extent) & aux.active
    rot = quat_to_rotmat(get_rotation(params))

    def sampled(eps):
        return params.xyz + torch.einsum("nij,nj->ni", rot, eps * scal)

    new_scaling = torch.log(scal / (0.8 * 2.0))
    split_a = params._replace(xyz=sampled(noise[0]), scaling=new_scaling)
    split_b = params._replace(xyz=sampled(noise[1]), scaling=new_scaling)
    slots2, ok2 = _alloc_slots(aux.active, split_mask, max_new)
    params = _map(lambda d, s: _scatter_rows(d, s, slots2, ok2), params, split_b)
    opt = _zero_moments(opt, slots2, ok2)
    aux = aux._replace(
        active=_scatter_value(aux.active, slots2, ok2, True),
        kf_id=_scatter_rows(aux.kf_id, aux.kf_id, slots2, ok2),
        n_obs=_scatter_rows(aux.n_obs, aux.n_obs, slots2, ok2),
    )
    # Replace only originals whose sibling got a slot.
    repl = split_mask & ok2

    def rmask(t):
        return repl.reshape((-1,) + (1,) * (t.dim() - 1))

    params = _map(lambda d, s: torch.where(rmask(d), s, d), params, split_a)
    opt = AdamState(
        mu=_map(lambda m: torch.where(rmask(m), torch.zeros_like(m), m), opt.mu),
        nu=_map(lambda m: torch.where(rmask(m), torch.zeros_like(m), m), opt.nu),
        count=opt.count,
    )

    prune = torch.sigmoid(params.opacity[:, 0]) < min_opacity
    if max_screen_size is not None:
        prune = prune | (aux.max_radii2d > max_screen_size)
        prune = prune | (torch.amax(get_scaling(params), dim=1) > 0.1 * extent)
    aux = aux._replace(
        active=aux.active & ~prune,
        xyz_grad_accum=torch.zeros_like(aux.xyz_grad_accum),
        denom=torch.zeros_like(aux.denom),
        max_radii2d=torch.zeros_like(aux.max_radii2d),
    )
    with span("sync.map.densify"):
        overflow = bool((clone_mask.sum() > ok.sum()) | (split_mask.sum() > ok2.sum()))
    return params, aux, opt, overflow


def prune_only(params: GaussianParams, aux: GaussianAux, mask) -> GaussianAux:
    return aux._replace(active=aux.active & ~mask)


def _zero_opacity_moments(opt: AdamState) -> AdamState:
    return AdamState(
        mu=opt.mu._replace(opacity=torch.zeros_like(opt.mu.opacity)),
        nu=opt.nu._replace(opacity=torch.zeros_like(opt.nu.opacity)),
        count=opt.count,
    )


def reset_opacity(params: GaussianParams, opt: AdamState, value: float = 0.01):
    """Every opacity to `value`, opacity Adam moments zeroed."""
    params = params._replace(
        opacity=torch.full_like(params.opacity, inverse_sigmoid(value)))
    return params, _zero_opacity_moments(opt)


def reset_opacity_nonvisible(params: GaussianParams, opt: AdamState, visible,
                             value: float = 0.4):
    """Reset the opacity of non-visible Gaussians only."""
    target = torch.full_like(params.opacity, inverse_sigmoid(value))
    params = params._replace(
        opacity=torch.where(visible[:, None], params.opacity, target))
    return params, _zero_opacity_moments(opt)


def compact(params: GaussianParams, aux: GaussianAux, opt: AdamState,
            new_capacity: int):
    """Pack active slots to the front of tensors of `new_capacity`.
    Returns (params, aux, opt, n_active)."""
    idx = torch.nonzero(aux.active).flatten()
    n = int(idx.shape[0])
    if n > new_capacity:
        raise ValueError(f"{n} active > capacity {new_capacity}")

    def pack(a, fill=0):
        out = torch.full((new_capacity,) + tuple(a.shape[1:]), fill,
                         dtype=a.dtype, device=a.device)
        out[:n] = a[idx]
        return out

    params = _map(pack, params)
    opt = AdamState(mu=_map(pack, opt.mu), nu=_map(pack, opt.nu), count=opt.count)
    aux = GaussianAux(
        active=pack(aux.active, False), max_radii2d=pack(aux.max_radii2d),
        xyz_grad_accum=pack(aux.xyz_grad_accum), denom=pack(aux.denom),
        kf_id=pack(aux.kf_id, -1), n_obs=pack(aux.n_obs),
    )
    return params, aux, opt, n


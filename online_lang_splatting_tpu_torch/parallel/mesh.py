"""Multi-device execution (port of parallel/mesh.py): a device mesh and the
data-parallel steps.

The JAX package runs these as single-controller SPMD under `shard_map`.
The port keeps the single controller: a `Mesh` is an ordered list of torch
devices, and one process drives them all.

- A shard's work runs on its own device, on a contiguous equal share of
  the sharded axis (`P("dp")`).
- A replicated input reaches each shard through `.to(device)`; autograd
  sums the gradients back through it, the psum of the shard_map
  transpose.
- psum / pmax / pmean of per-shard results are explicit reductions on the
  mesh's first device, where the replicated update runs.

`dp_ae_train_step` is the data-parallel autoencoder step (the reference's
Lightning DDP); `dp_mapping_iteration` the full mapping iteration with the
keyframe slots sharded (BackEnd with a mesh), through `sharded_slot_grads`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class Mesh(NamedTuple):
    devices: tuple  # torch.device per shard, in shard order

    @property
    def size(self) -> int:
        return len(self.devices)


def named_mesh(devices: Sequence) -> Mesh:
    """A mesh over the named devices, in order. One device may drive
    several shards (the tests' 8-shard CPU mesh, several bands on one
    card); `make_mesh` never builds such a mesh."""
    return Mesh(tuple(torch.device(d) for d in devices))


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The first `n_devices` cards (all of them when None) as a mesh. Raises
    when fewer exist: a repeated device never stands in for a missing
    one. The CPU is one device."""
    kind = torch.device(device).type
    have = torch.cuda.device_count() if kind == "cuda" else 1
    n = n_devices or have
    if n > have:
        raise ValueError(f"a mesh of {n} {kind} devices was asked for, {have} "
                         f"exist; to put several shards on one device, name "
                         f"the devices (parallel.mesh.named_mesh)")
    if kind == "cuda":
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return Mesh((torch.device(kind),))


def shard_slices(n: int, mesh: Mesh) -> list:
    """The contiguous equal shares of an axis of length `n`, one per shard."""
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not split into {mesh.size} shards")
    k = n // mesh.size
    return [slice(i * k, (i + 1) * k) for i in range(mesh.size)]


def to_device(x, device):
    """Tensors, and tuples / lists of them (NamedTuples kept), on `device`;
    anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    return x


# ---------------------------------------------------------------------------
# Data-parallel autoencoder training


def dp_ae_train_step(model, optimizer, mesh: Mesh):
    """step(x) -> loss: one online-AE step (models/autoencoder.
    online_train_step) with the batch split over the mesh, the parameters
    replicated, and the loss and gradients the mean over the shards
    (pmean). The model and its optimizer live on the mesh's first device."""
    from torch.func import functional_call

    from ..models.autoencoder import online_loss

    def step(x):
        d0 = mesh.devices[0]
        params = dict(model.named_parameters())
        losses = []
        for dev, sl in zip(mesh.devices, shard_slices(x.shape[0], mesh)):
            xk = x[sl].to(dev)
            pred = functional_call(model, to_device(params, dev), (xk,))
            losses.append(online_loss(pred, xk).to(d0))
        loss = torch.stack(losses).mean()
        optimizer.step(torch.autograd.grad(loss, optimizer.params))
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# Data-parallel mapping (keyframe-sharded SLAM optimization)


def sharded_slot_grads(mesh: Mesh):
    """`slam.backend.scan_slot_grads` (the same arguments and outputs) with
    the keyframe slots sharded over the mesh: each shard renders and
    differentiates its slots on its device; the per-Gaussian gradients,
    the loss and the additive statistics are summed and the max radii maxed
    on the first device; the per-slot outputs are concatenated in slot
    order."""

    def fn(params, active, proj, slot_r, slot_t, slot_ea, slot_eb, images,
           depths, langs, lang_on, slot_valid, lang_weight, *, settings,
           init_mode: bool):
        from ..models.gaussians import GaussianParams
        from ..slam.backend import scan_slot_grads

        d0 = mesh.devices[0]
        parts = []
        for dev, sl in zip(mesh.devices, shard_slices(slot_r.shape[0], mesh)):
            out = scan_slot_grads(
                to_device(params, dev), active.to(dev), proj.to(dev),
                *(to_device(x[sl], dev) for x in (slot_r, slot_t, slot_ea, slot_eb,
                                                   images, depths, langs)),
                lang_on[sl], slot_valid[sl], to_device(lang_weight, dev),
                settings=settings, init_mode=init_mode)
            parts.append(to_device(out, d0))
        grads = GaussianParams(*(sum(fs) for fs in zip(*(p[0] for p in parts))))
        loss = sum(p[1] for p in parts)
        per_slot = tuple(torch.cat(fs) for fs in zip(*(p[2] for p in parts)))
        radii, accum, denom = zip(*(p[3] for p in parts))
        stats = (torch.stack(radii).amax(0), sum(accum), sum(denom))
        return grads, loss, per_slot, stats

    return fn


def dp_mapping_iteration(settings, mesh: Mesh, n_slots: int, init_mode: bool):
    """The full mapping iteration (`slam.backend.mapping_iteration`: the
    same positional arguments and outputs) with the keyframe slots sharded
    over the mesh by `sharded_slot_grads`; the update tail runs on the
    first device. `n_slots` must split evenly (BackEnd pads with invalid
    slots)."""
    from functools import partial

    from ..slam.backend import mapping_iteration

    shard_slices(n_slots, mesh)  # raises unless the slots split evenly
    return partial(mapping_iteration, settings=settings, init_mode=init_mode,
                   slot_grads=sharded_slot_grads(mesh))

"""Binary little-endian PLY writer and reader (port of utils/ply.py).

Gaussian snapshots keep the reference's vertex layout (x, y, z, nx, ny, nz,
f_dc_*, f_rest_*, f_language_*, opacity, scale_*, rot_*; float32), so the
port and the JAX package read each other's files."""

from __future__ import annotations

import numpy as np
import torch

_TYPES = {"float": np.float32, "int": np.int32, "uchar": np.uint8, "double": np.float64}
_NAMES = {np.dtype(np.float32): "float", np.dtype(np.int32): "int",
          np.dtype(np.uint8): "uchar"}


def write_ply(path, fields: dict[str, np.ndarray]):
    """fields: name -> (N,) float32 / int32 / uint8 columns, in order."""
    n = len(next(iter(fields.values())))
    cols = {k: np.ascontiguousarray(v) for k, v in fields.items()}
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property {_NAMES[col.dtype]} {name}" for name, col in cols.items()]
    header.append("end_header")
    rec = np.rec.fromarrays(list(cols.values()), names=list(cols.keys()))
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())


def read_ply(path) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    n = None
    props = []
    for line in data[:head_end].decode().splitlines():
        parts = line.split()
        if parts[:2] == ["element", "vertex"]:
            n = int(parts[2])
        elif parts and parts[0] == "property" and n is not None:
            props.append((parts[2], _TYPES[parts[1]]))
    dtype = np.dtype(props)
    rec = np.frombuffer(data[head_end:head_end + n * dtype.itemsize], dtype)
    return {name: np.array(rec[name]) for name, _ in props}


def save_gaussians_ply(path, params, aux):
    """The active Gaussians of `params` (GaussianParams of tensors) in the
    reference's snapshot layout."""
    active = aux.active.cpu().numpy()

    def rows(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy()[active].reshape(int(active.sum()), -1)

    xyz = rows(params.xyz)
    fields = {c: xyz[:, i] for i, c in enumerate("xyz")}
    fields.update({f"n{c}": np.zeros(len(xyz), np.float32) for c in "xyz"})
    for prefix, x in (("f_dc", params.features_dc), ("f_rest", params.features_rest),
                      ("f_language", params.language)):
        cols = rows(x)
        fields.update({f"{prefix}_{i}": cols[:, i] for i in range(cols.shape[1])})
    fields["opacity"] = rows(params.opacity)[:, 0]
    for prefix, x in (("scale", params.scaling), ("rot", params.rotation)):
        cols = rows(x)
        fields.update({f"{prefix}_{i}": cols[:, i] for i in range(cols.shape[1])})
    write_ply(path, fields)


def load_gaussians_ply(path, capacity: int | None = None, device="cpu"):
    """A snapshot read back into (GaussianParams, GaussianAux) at
    `capacity` slots (default: the next power of two, at least 1024), the
    vertices in the first slots."""
    from ..models import gaussians as G

    d = read_ply(path)
    n = len(d["x"])
    cap = capacity or max(1 << (n - 1).bit_length(), 1024)
    lang_dims = sorted(int(k.split("_")[-1]) for k in d if k.startswith("f_language_"))
    rest_dims = sorted(int(k.split("_")[-1]) for k in d if k.startswith("f_rest_"))
    n_rest = len(rest_dims) // 3
    sh_degree = int(np.sqrt(n_rest + 1)) - 1
    params = G.empty_params(cap, sh_degree, len(lang_dims), device)
    aux = G.empty_aux(cap, device)

    def stack(keys) -> np.ndarray:
        return np.stack([d[k] for k in keys], -1) if keys else np.zeros((n, 0), np.float32)

    values = dict(
        xyz=stack(["x", "y", "z"]),
        features_dc=stack([f"f_dc_{i}" for i in range(3)])[:, None, :],
        features_rest=stack([f"f_rest_{i}" for i in rest_dims]).reshape(n, n_rest, 3),
        scaling=stack(sorted(k for k in d if k.startswith("scale_"))),
        rotation=stack([f"rot_{i}" for i in range(4)]),
        opacity=d["opacity"][:, None],
        language=stack([f"f_language_{i}" for i in lang_dims]),
    )

    def put(field: torch.Tensor, value: np.ndarray) -> torch.Tensor:
        out = field.clone()
        out[:n] = torch.as_tensor(value, device=field.device)
        return out

    params = G.GaussianParams(*(put(getattr(params, f), values[f])
                                for f in G.GaussianParams._fields))
    active = aux.active.clone()
    active[:n] = True
    return params, aux._replace(active=active)

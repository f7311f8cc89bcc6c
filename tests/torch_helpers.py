"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The tier-1 suite runs several pytest workers at once, so each worker's
torch stays at two threads. Data passes between JAX and torch as numpy.
"""

import numpy as np
import torch

torch.set_num_threads(2)


def t(a, dtype=None):
    """numpy / JAX array -> CPU torch tensor (same dtype unless given)."""
    out = torch.as_tensor(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor / JAX array / scalar -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_normalized(got, ref, tol, msg=""):
    """max |got - ref| / max(|ref|max, 1) <= tol (the goldens' metric)."""
    got, ref = n(got).astype(np.float64), n(ref).astype(np.float64)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    if ref.size == 0:
        return
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, f"{msg}: normalized error {err:.3e} > {tol}"


def numpy_map(seed=0, n_pts=300, lang_dim=15, cap=512, depth=3.0, spread=1.0):
    """A random Gaussian map as {field: ndarray} in the JAX package's layout
    (fixed capacity, first n_pts slots active)."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n_pts, 0] = rng.uniform(-spread, spread, n_pts)
    xyz[:n_pts, 1] = rng.uniform(-spread * 0.7, spread * 0.7, n_pts)
    xyz[:n_pts, 2] = rng.uniform(depth - 0.5, depth + 0.5, n_pts)
    tree = dict(
        xyz=xyz,
        features_dc=np.zeros((cap, 1, 3), np.float32),
        features_rest=np.zeros((cap, 0, 3), np.float32),
        scaling=np.zeros((cap, 3), np.float32),
        rotation=np.zeros((cap, 4), np.float32),
        opacity=np.full((cap, 1), -9.21, np.float32),
        language=np.zeros((cap, lang_dim), np.float32),
        active=np.zeros(cap, bool),
    )
    tree["rotation"][:, 0] = 1.0
    tree["features_dc"][:n_pts, 0] = rng.normal(size=(n_pts, 3)) * 0.5
    tree["scaling"][:n_pts] = np.log(rng.uniform(0.03, 0.12, (n_pts, 3)))
    q = rng.normal(size=(n_pts, 4))
    tree["rotation"][:n_pts] = q / np.linalg.norm(q, axis=1, keepdims=True)
    tree["opacity"][:n_pts, 0] = rng.uniform(-1.0, 2.0, n_pts)
    tree["language"][:n_pts] = rng.normal(size=(n_pts, lang_dim)) * 0.3
    tree["active"][:n_pts] = True
    return tree


def jax_params_aux(tree):
    """The same map as the JAX package's (GaussianParams, GaussianAux)."""
    import jax.numpy as jnp

    from online_lang_splatting_tpu.models import gaussians as JG

    params = JG.GaussianParams(*(jnp.asarray(tree[f]) for f in JG.GaussianParams._fields))
    aux = JG.empty_aux(tree["xyz"].shape[0])._replace(active=jnp.asarray(tree["active"]))
    return params, aux


def map_from_frame(ds, frame=0, n_pts=400, cap=1024, seed=0):
    """A numpy map back-projected from a frame: every field in the JAX
    package's layout."""
    rng = np.random.default_rng(seed)
    color, depth, w2c, _, _ = ds[frame]
    ys, xs = np.nonzero(depth > 0)
    pick = rng.choice(len(ys), n_pts, replace=False)
    ys, xs = ys[pick], xs[pick]
    z = depth[ys, xs]
    cam = np.stack([(xs - ds.cx) / ds.fx * z, (ys - ds.cy) / ds.fy * z, z], -1)
    c2w = np.linalg.inv(w2c.astype(np.float64))
    world = cam @ c2w[:3, :3].T + c2w[:3, 3]
    tree = dict(
        xyz=np.zeros((cap, 3), np.float32), features_dc=np.zeros((cap, 1, 3), np.float32),
        features_rest=np.zeros((cap, 0, 3), np.float32),
        scaling=np.zeros((cap, 3), np.float32), rotation=np.zeros((cap, 4), np.float32),
        opacity=np.full((cap, 1), -9.21, np.float32),
        language=np.zeros((cap, 15), np.float32), active=np.zeros(cap, bool))
    tree["rotation"][:, 0] = 1.0
    tree["xyz"][:n_pts] = world
    tree["features_dc"][:n_pts, 0] = (color[:, ys, xs].T - 0.5) / 0.28209479177387814
    # Anisotropic, rotated splats: with isotropic ones the rotation gradient
    # is analytically zero and Adam would turn rounding noise into lr-sized
    # steps.
    tree["scaling"][:n_pts] = np.log(0.012 * z[:, None] * rng.uniform(0.5, 1.5, (n_pts, 3)))
    q = rng.normal(size=(n_pts, 4))
    tree["rotation"][:n_pts] = q / np.linalg.norm(q, axis=1, keepdims=True)
    tree["opacity"][:n_pts] = 1.5
    tree["language"][:n_pts] = rng.normal(size=(n_pts, 15)) * 0.2
    tree["active"][:n_pts] = True
    return tree

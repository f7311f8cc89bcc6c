"""The port's 3D evaluation modules against the JAX package on the CPU:
TSDF fusion (15 and 3 channels), meshing, Chamfer and the approximate EMD.

Tolerances: fusion and meshing are exact (the same float32 expressions;
voxels whose projection falls on a rounding tie are counted and left out).
Chamfer and EMD compute squared distances as |x|^2 - 2 x.y + |y|^2 in
float32 in both packages, which cancels at world coordinates: near the
origin the per-point gap is ~1e-3 m, at an 8 m offset up to ~8e-3 m, and
the EMD's first level (-4^7) multiplies that rounding inside an exponent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, t

from online_lang_splatting_tpu.ops import chamfer as jchamfer
from online_lang_splatting_tpu.ops import emd as jemd
from online_lang_splatting_tpu.tsdf import fusion as jfusion
from online_lang_splatting_tpu.tsdf import meshing as jmeshing
from online_lang_splatting_tpu_torch.ops import chamfer, emd
from online_lang_splatting_tpu_torch.slam.config import load_config
from online_lang_splatting_tpu_torch.slam.datasets import SyntheticDataset
from online_lang_splatting_tpu_torch.tsdf import fusion, meshing

SMOKE = "configs/synthetic/smoke.yaml"


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticDataset(load_config(SMOKE))
    fr = [ds[i] for i in (0, 3)]
    intr = (ds.fx, ds.fy, ds.cx, ds.cy)
    return ds, fr, intr


def _tie_voxels(vol, intr, poses, margin=1e-4):
    """Voxels whose projection in any frame lies within `margin` px of a
    rounding tie (float64), where float32 rounding may pick either pixel."""
    fx, fy, cx, cy = intr
    world = vol.world(torch.arange(vol.n_voxels)).numpy().astype(np.float64)
    tie = np.zeros(vol.n_voxels, bool)
    for w2c in poses:
        cam = world @ w2c[:3, :3].T.astype(np.float64) + w2c[:3, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            for val in (cam[:, 0] / cam[:, 2] * fx + cx, cam[:, 1] / cam[:, 2] * fy + cy):
                tie |= np.abs(np.abs(val - np.floor(val)) - 0.5) < margin
    return tie


@pytest.mark.parametrize("channels", [15, 3])
def test_integrate_matches_jax(frames, channels):
    ds, fr, intr = frames
    rng = np.random.default_rng(channels)
    feats = [rng.normal(size=(channels, ds.height, ds.width)).astype(np.float32) for _ in fr]
    bounds = fusion.estimate_bounds([f[1] for f in fr], intr, [f[2] for f in fr])
    np.testing.assert_array_equal(
        bounds, jfusion.estimate_bounds([f[1] for f in fr], intr, [f[2] for f in fr]))
    vol = fusion.TSDFVolume(bounds, 0.1, channels, device="cpu", chunk=7777)
    jvol = jfusion.TSDFVolume(bounds, 0.1, channels)
    np.testing.assert_array_equal(vol.dims, jvol.dims)
    np.testing.assert_array_equal(vol.world(torch.arange(vol.n_voxels)).numpy(),
                                  np.asarray(jvol._world))
    for f, (_, depth, w2c, _, _) in zip(feats, fr):
        vol.integrate(f, depth, intr, w2c)
        jvol.integrate(f, depth, intr, w2c)
    keep = ~_tie_voxels(vol, intr, [f[2] for f in fr])
    assert keep.mean() > 0.999
    assert float(n(vol.weights).max()) == 2.0
    np.testing.assert_allclose(n(vol.tsdf)[keep], n(jvol.tsdf)[keep], atol=1e-5)
    np.testing.assert_allclose(n(vol.weights)[keep], n(jvol.weights)[keep], atol=1e-5)
    np.testing.assert_allclose(n(vol.features)[:, keep], n(jvol.features)[:, keep], atol=1e-5)
    pts, fts = vol.get_point_cloud()
    jpts, jfts = jvol.get_point_cloud()
    assert len(pts) > 1000
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_allclose(fts, jfts, atol=1e-5)
    tsdf, fv = vol.get_volume()
    jtsdf, jfv = jvol.get_volume()
    assert tsdf.shape == jtsdf.shape and fv.shape == jfv.shape


def _mesh_eq(got, ref):
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_marching_cubes_all_configurations():
    """Every corner-sign configuration of one cell (and of a cell beside an
    unobserved voxel) meshes identically, table and vertices."""
    np.testing.assert_array_equal(meshing._mc_tables(), jmeshing._mc_tables())
    rng = np.random.default_rng(0)
    for cfg in range(256):
        vals = np.array([1.0 if (cfg >> c) & 1 else -1.0 for c in range(8)], np.float32)
        vals *= rng.uniform(0.2, 1.0, 8).astype(np.float32)
        grid = np.zeros((2, 2, 2), np.float32)
        for c, (x, y, z) in enumerate(meshing._CORNERS):
            grid[x, y, z] = vals[c]
        _mesh_eq(meshing.marching_cubes(grid), jmeshing.marching_cubes(grid))
        _mesh_eq(meshing.surface_nets(np.pad(grid, 1, constant_values=1.0)),
                 jmeshing.surface_nets(np.pad(grid, 1, constant_values=1.0)))


def test_meshers_random_field():
    rng = np.random.default_rng(1)
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, 14)] * 3, indexing="ij")
    field = (np.sqrt(x**2 + y**2 + z**2) - 0.6 + rng.normal(size=x.shape) * 0.05).astype(np.float32)
    weights = (rng.uniform(size=field.shape) > 0.05).astype(np.float32)
    for w in (None, weights):
        got = meshing.marching_cubes(field, w)
        assert len(got[1]) > 100
        _mesh_eq(got, jmeshing.marching_cubes(field, w))
        _mesh_eq(meshing.surface_nets(field, w), jmeshing.surface_nets(field, w))


@pytest.mark.parametrize("method", ["marching_cubes", "surface_nets"])
def test_extract_mesh_and_ply_match_jax(frames, tmp_path, method):
    ds, fr, intr = frames
    bounds = fusion.estimate_bounds([f[1] for f in fr], intr, [f[2] for f in fr])
    vol = fusion.TSDFVolume(bounds, 0.1, 3, device="cpu")
    jvol = jfusion.TSDFVolume(bounds, 0.1, 3)
    for color, depth, w2c, _, _ in fr:
        vol.integrate(color, depth, intr, w2c)
        jvol.integrate(color, depth, intr, w2c)
    got = meshing.extract_mesh(vol, method=method)
    ref = jmeshing.extract_mesh(jvol, method=method)
    assert len(got[1]) > 100
    _mesh_eq(got[:2], ref[:2])
    np.testing.assert_allclose(got[2], ref[2], atol=1e-5)
    for colors in (None, np.clip(got[2], 0, 1)):
        meshing.write_mesh_ply(tmp_path / "a.ply", got[0], got[1], colors=colors)
        jmeshing.write_mesh_ply(tmp_path / "b.ply", got[0], got[1], colors=colors)
        assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


def _cloud(rng, n_pts, offset):
    return (rng.uniform(0, 3, size=(n_pts, 3)) + offset).astype(np.float32)


@pytest.mark.parametrize("offset,mean_tol,point_tol", [(0.0, 1e-5, 2e-3), (8.0, 1e-3, 1e-2)])
def test_chamfer_matches_jax(offset, mean_tol, point_tol):
    rng = np.random.default_rng(2)
    x, y = _cloud(rng, 1300, offset), _cloud(rng, 700, offset)
    for a, b in ((x, y), (y, x)):
        got = n(chamfer.nn_dist(t(a), t(b), block=512))
        ref = n(jchamfer.nn_dist(jnp.asarray(a), jnp.asarray(b), block=512))
        assert got.shape == (len(a),)
        np.testing.assert_allclose(got, ref, atol=point_tol)
        exact = np.sqrt(((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1)).min(1)
        np.testing.assert_allclose(got, exact, atol=point_tol)
    got = chamfer.chamfer_distance(t(x), t(y), block=512)
    ref = jchamfer.chamfer_distance(jnp.asarray(x), jnp.asarray(y), block=512)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=mean_tol)
    # Column chunks give the same minimum as one product.
    whole = n(chamfer.nn_dist(t(x), t(y), block=512))
    limit = chamfer.MAX_ELEMS
    try:
        chamfer.MAX_ELEMS = 512 * 100
        np.testing.assert_array_equal(n(chamfer.nn_dist(t(x), t(y), block=512)), whole)
    finally:
        chamfer.MAX_ELEMS = limit


@pytest.mark.parametrize("offset", [0.0, 5.0])
@pytest.mark.parametrize("sizes", [(150, 400), (400, 150), (256, 256)])
def test_emd_matches_jax(sizes, offset):
    """The match within 1e-2 normalized, the cost and its gradient (with the
    match held fixed, as the backward holds it) within 1e-3 relative, and
    the whole EMD within 1e-3; near the origin the gradient of the whole
    EMD (each package's own match) within 1e-3 too."""
    rng = np.random.default_rng(sum(sizes))
    x = (rng.normal(size=(sizes[0], 3)) * 0.5 + offset).astype(np.float32)
    y = (rng.normal(size=(sizes[1], 3)) * 0.5 + offset + 0.1).astype(np.float32)
    got = n(emd.approx_match(t(x), t(y)))
    ref = n(jemd.approx_match(jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == ref.shape == (sizes[1], sizes[0])
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-2

    def rel(a, b):
        a, b = n(a), n(b)
        return float(np.abs(a - b).max() / np.abs(b).max())

    xt = t(x).requires_grad_(True)
    cost = emd.match_cost(xt, t(y), t(ref))
    (g,) = torch.autograd.grad(cost, [xt])
    jcost, jg = jax.value_and_grad(jemd.match_cost)(jnp.asarray(x), jnp.asarray(y),
                                                    jnp.asarray(ref))
    assert rel(cost.detach(), jcost) <= 1e-3
    assert rel(g, jg) <= 1e-3

    xt, yt = t(x).requires_grad_(True), t(y).requires_grad_(True)
    val = emd.earth_mover_distance(xt, yt)
    gx, gy = torch.autograd.grad(val, [xt, yt])
    jval, (jgx, jgy) = jax.value_and_grad(jemd.earth_mover_distance, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    assert rel(val.detach(), jval) <= 1e-3
    if offset == 0.0:
        assert rel(gx, jgx) <= 1e-3 and rel(gy, jgy) <= 1e-3

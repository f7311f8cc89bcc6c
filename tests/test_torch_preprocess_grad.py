"""The preprocess as one autograd Function (ops/raster/preprocess.py:
project_gaussians) against autograd of the plain forward (`preprocess`).

CPU: in float64 the hand-derived backward (`preprocess_backward_plain`,
the CPU path) equals autograd of `preprocess` to 1e-10 relative, on the
five golden scenes and an edge scene (Gaussians behind the camera and
inside the near plane, means past and exactly at the 1.3·tan(fov) clamp,
flat and near-singular covariances, inert opacities), at SH degree 0 and 3
and with precomputed colours, for the gradients tracking asks for (the
view and full projection only) and mapping's (every leaf and the 2D-mean
offset); the outputs equal `preprocess`'s, integers exactly, at the
goldens' tiles 16 and 32.

Card (marked `card`, skipped without CUDA; the file imports nothing of
JAX, so it runs on the card with
`python3 -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_preprocess_grad.py`): the kernels against the plain pair
at the orbit cell's shape (131072 slots, ~40000 live, 1200x680, tile 32)
through `chip_smoke.preprocess_check`, and a tracking iteration's launch
counts.
"""

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets the torch thread count)

from online_lang_splatting_tpu_torch.ops import graphics, lie
from online_lang_splatting_tpu_torch.ops.raster import preprocess as P
from online_lang_splatting_tpu_torch.ops.raster import scenes

F64 = torch.float64
GRAD_RTOL = 1e-10


def _edge_scene() -> dict:
    """64 Gaussians at the preprocess's edges, identity camera at 64x48."""
    rng = np.random.default_rng(16)
    n = 64
    view, proj, tanfovx, tanfovy = scenes.make_camera(64, 48)
    means = np.zeros((n, 3))
    means[:, 0] = rng.uniform(-0.8, 0.8, n)
    means[:, 1] = rng.uniform(-0.6, 0.6, n)
    means[:, 2] = rng.uniform(2.0, 6.0, n)
    means[0:6, 2] = [-1.0, -0.05, 0.0, 0.05, 0.19, -3.0]     # behind / inside the near plane
    lim_x, lim_y = 1.3 * tanfovx, 1.3 * tanfovy
    means[6:10, 0] = [3.0 * lim_x * 2.5, -2.0 * lim_x * 3.0, 0.0, 0.0]  # past the x clamp
    means[6:10, 2] = [2.5, 3.0, 2.0, 2.0]
    means[8:10, 1] = [-4.0 * lim_y * 2.0, 1.5 * lim_y * 2.0]  # past the y clamp
    means[10, :] = [lim_x * 2.0, lim_y * 2.0, 2.0]             # exactly at both clamps
    means[11, :] = [-lim_x * 4.0, -lim_y * 4.0, 4.0]
    scales = rng.uniform(0.05, 0.4, (n, 3))
    scales[12:16] = [[1e-6, 0.3, 1e-5], [1e-7, 1e-7, 1e-7], [2.0, 1e-6, 1e-6], [5.0, 5.0, 5.0]]
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    quats[16] = [1.0, 0.0, 0.0, 0.0]
    quats[17] = [0.3, -1.2, 0.4, 2.0]                           # not unit: no normalization
    opac = rng.uniform(0.05, 0.95, n)
    opac[18:21] = [1e-4, 1.0 / 255.0, 1e-13]                   # inert and clamped
    return dict(means3d=means, scales=scales, quats=quats, opacities=opac,
                viewmatrix=view, projmatrix=proj, width=64, height=48,
                tanfovx=tanfovx, tanfovy=tanfovy)


SCENES = {**scenes.SCENES, "edge": _edge_scene}


def _inputs(name: str, colour: str, seed: int = 0) -> dict:
    """The scene in float64, its camera moved off the identity (except the
    edge scene's, whose clamp ends are exact there), SH or colours."""
    sc = SCENES[name]()
    rng = np.random.default_rng(seed)
    n = sc["means3d"].shape[0]
    view = torch.as_tensor(np.asarray(sc["viewmatrix"], np.float64))
    if name != "edge":
        view = lie.se3_exp(torch.as_tensor(rng.normal(size=6) * [0.1, 0.1, 0.1, 0.05, 0.05, 0.05]))
    proj = torch.as_tensor(np.asarray(sc["projmatrix"], np.float64))
    deg = {"sh0": 0, "sh3": 3, "precomp": 0}[colour]
    inp = dict(
        means3d=torch.as_tensor(np.asarray(sc["means3d"], np.float64)),
        scales=torch.as_tensor(np.asarray(sc["scales"], np.float64)),
        quats=torch.as_tensor(np.asarray(sc["quats"], np.float64)),
        opacities=torch.as_tensor(np.asarray(sc["opacities"], np.float64)),
        viewmatrix=view, projmatrix=proj @ view,
        shs=None if colour == "precomp" else torch.as_tensor(
            rng.normal(size=(n, 16, 3)) * 0.4),
        colors_precomp=(torch.as_tensor(rng.uniform(size=(n, 3)))
                        if colour == "precomp" else None),
        means2d_offset=torch.zeros((n, 2), dtype=F64))
    kw = dict(sh_degree=deg, width=sc["width"], height=sc["height"], tan_fovx=sc["tanfovx"],
              tan_fovy=sc["tanfovy"])
    return inp, kw


LEAVES = {"pose": ("viewmatrix", "projmatrix"),
          "all": ("means3d", "scales", "quats", "shs", "colors_precomp", "means2d_offset",
                  "viewmatrix", "projmatrix")}


def _grads(fn, inp: dict, kw: dict, leaves, tile: int = 16, seed: int = 1):
    """fn's outputs and the gradients of a random weighting of every float
    output (cotangents on every Gaussian, valid or not) in `leaves`."""
    x = {k: (v.clone().requires_grad_(k in leaves) if v is not None else None)
         for k, v in inp.items()}
    view = x["viewmatrix"]
    campos = -view.detach()[:3, :3].T @ view.detach()[:3, 3]
    out = fn(x["means3d"], x["scales"], x["quats"], x["opacities"], view, x["projmatrix"],
             campos, shs=x["shs"], colors_precomp=x["colors_precomp"],
             means2d_offset=x["means2d_offset"], tile=tile, **kw)
    rng = np.random.default_rng(seed)
    loss = sum((getattr(out, f) * torch.as_tensor(rng.normal(size=getattr(out, f).shape))).sum()
               for f in ("xy", "depth", "conic", "color"))
    wrt = [x[k] for k in leaves if x[k] is not None]
    return out, dict(zip([k for k in leaves if x[k] is not None],
                         torch.autograd.grad(loss, wrt)))


@pytest.mark.parametrize("subset", sorted(LEAVES))
@pytest.mark.parametrize("colour", ["sh0", "sh3", "precomp"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_backward_equals_autograd(name, colour, subset):
    inp, kw = _inputs(name, colour)
    ref_out, ref = _grads(P.preprocess, inp, kw, LEAVES[subset])
    P.BWD_STATS.reset()
    got_out, got = _grads(P.project_gaussians, inp, kw, LEAVES[subset])
    assert P.BWD_STATS.plain_calls == 1 and P.BWD_STATS.launches == 0
    for f in ref_out._fields:
        assert torch.equal(getattr(got_out, f), getattr(ref_out, f)), f
    assert set(got) == set(ref)
    for k, r in ref.items():
        err = float((got[k] - r).abs().max()) / max(float(r.abs().max()), 1e-300)
        assert err <= GRAD_RTOL, f"d_{k}: relative error {err:.3e}"


def test_edge_scene_reaches_every_guard():
    """The edge scene holds what its name says: Gaussians culled by the
    near plane, means past and at the clamp, inert opacities."""
    inp, kw = _inputs("edge", "sh0")
    view = inp["viewmatrix"]
    t = inp["means3d"] @ view[:3, :3].T + view[:3, 3]
    assert (t[:, 2] <= 0.2).sum() >= 5
    q = t[:, 0] / torch.where(t[:, 2] > 0.2, t[:, 2], torch.ones_like(t[:, 2]))
    lim = 1.3 * kw["tan_fovx"]
    assert (q.abs() > lim).sum() >= 2 and (q == lim).any()
    out = P.preprocess(inp["means3d"], inp["scales"], inp["quats"], inp["opacities"], view,
                       inp["projmatrix"], torch.zeros(3, dtype=F64), shs=inp["shs"], tile=16,
                       **kw)
    assert not out.valid[:5].any() and out.valid.sum() > 30
    assert (out.tiles_touched[[18, 20]] == 0).all()


def test_cov3d_precomp_gradients():
    inp, kw = _inputs("t_cutoff", "sh0")
    cov = P.compute_cov3d(inp["scales"], 1.0, inp["quats"]).detach()
    leaves = ("means3d", "cov3d", "viewmatrix", "projmatrix")
    grads = {}
    for fn in (P.preprocess, P.project_gaussians):
        x = {k: v.clone().requires_grad_(True) for k, v in (
            ("means3d", inp["means3d"]), ("cov3d", cov), ("viewmatrix", inp["viewmatrix"]),
            ("projmatrix", inp["projmatrix"]))}
        out = fn(x["means3d"], None, None, inp["opacities"], x["viewmatrix"], x["projmatrix"],
                 torch.zeros(3, dtype=F64), shs=inp["shs"], cov3d_precomp=x["cov3d"], tile=16,
                 **kw)
        rng = np.random.default_rng(3)
        loss = sum((getattr(out, f) * torch.as_tensor(rng.normal(size=getattr(out, f).shape)))
                   .sum() for f in ("xy", "depth", "conic", "color"))
        grads[fn] = torch.autograd.grad(loss, [x[k] for k in leaves])
    for k, r, g in zip(leaves, grads[P.preprocess], grads[P.project_gaussians]):
        err = float((g - r).abs().max()) / float(r.abs().max())
        assert err <= GRAD_RTOL, f"d_{k}: relative error {err:.3e}"


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_outputs_equal_preprocess_float32(name, tile):
    """The goldens' float32 inputs and tiles: every field, the integers
    included, equals `preprocess`'s."""
    inp, kw = _inputs(name, "sh0")
    inp = {k: None if v is None else v.float() for k, v in inp.items()}
    campos = torch.zeros(3)
    args = (inp["means3d"], inp["scales"], inp["quats"], inp["opacities"], inp["viewmatrix"],
            inp["projmatrix"], campos)
    ref = P.preprocess(*args, shs=inp["shs"], tile=tile, **kw)
    got = P.project_gaussians(*args, shs=inp["shs"], tile=tile, **kw)
    for f in ref._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert got.valid.any()


def test_function_gradcheck_f64():
    """gradcheck (fast mode) of the Function through its CPU path on 8
    Gaussians, every leaf at once."""
    inp, kw = _inputs("alpha_clamp", "sh3")
    sel = slice(0, 8)
    leaves = [inp[k][sel].clone().requires_grad_(True)
              for k in ("means3d", "scales", "quats", "shs")]
    view = inp["viewmatrix"].clone().requires_grad_(True)
    full = inp["projmatrix"].clone().requires_grad_(True)
    campos = torch.tensor([0.1, -0.2, 0.05], dtype=F64)

    def fn(means, scales, quats, shs, v, f):
        out = P.project_gaussians(means, scales, quats, inp["opacities"][sel], v, f, campos,
                                  shs=shs, tile=16, **kw)
        return out.xy, out.depth, out.conic, out.color

    assert torch.autograd.gradcheck(fn, (*leaves, view, full), fast_mode=True)


def test_cpu_tensors_take_the_plain_pair():
    P.FWD_STATS.reset()
    P.BWD_STATS.reset()
    got = scenes.render_scene(scenes.SCENES["alpha_clamp"](), "cuda", tile=16)
    assert np.isfinite(got["d_means"]).all()
    assert (P.FWD_STATS.plain_calls, P.BWD_STATS.plain_calls) == (1, 1)
    assert (P.FWD_STATS.launches, P.BWD_STATS.launches) == (0, 0)
    assert P.FWD_STATS.plain_by_channels == {0: 1}


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def orbit_map(device, seed: int = 0, capacity: int = 131072, live: int = 40000,
              sh_coeffs: int = 1):
    """A map at the orbit cell's shape: `capacity` slots, the first `live`
    Gaussians on the frustum of a 1200x680 camera (fx = fy = 600) 1.5-6 m
    away, the rest empty slots as models/gaussians.py leaves them (zero
    mean, unit scale, identity rotation, opacity 0). Returns (inputs
    dict, view, proj, settings kwargs)."""
    g = torch.Generator().manual_seed(seed)
    width, height, fx = 1200, 680, 600.0
    z = torch.rand(live, generator=g) * 4.5 + 1.5
    means = torch.zeros((capacity, 3))
    means[:live, 0] = (torch.rand(live, generator=g) * 2.4 - 1.2) * z
    means[:live, 1] = (torch.rand(live, generator=g) * 1.4 - 0.7) * z
    means[:live, 2] = z
    scales = torch.ones((capacity, 3))
    scales[:live] = torch.exp(torch.randn((live, 3), generator=g) * 0.5 - 4.0)
    quats = torch.zeros((capacity, 4))
    quats[:, 0] = 1.0
    q = torch.randn((live, 4), generator=g)
    quats[:live] = q / q.norm(dim=1, keepdim=True)
    opac = torch.zeros(capacity)
    opac[:live] = torch.sigmoid(torch.randn(live, generator=g))
    shs = torch.zeros((capacity, sh_coeffs, 3))
    shs[:live] = torch.randn((live, sh_coeffs, 3), generator=g) * 0.5
    # A camera turned off the axes, so that every entry of the full
    # projection's rows takes part in the products.
    view = lie.se3_exp(torch.tensor([0.05, -0.02, 0.1, 0.03, -0.08, 0.02]))
    proj = graphics.projection_matrix(0.01, 100.0, width / 2, height / 2, fx, fx, width, height)
    inputs = {k: v.to(device) for k, v in dict(means3d=means, scales=scales, quats=quats,
                                               opacities=opac, shs=shs).items()}
    settings = dict(image_width=width, image_height=height, tanfovx=width / (2 * fx),
                    tanfovy=height / (2 * fx), tile=32)
    return inputs, view.to(device), proj.to(device), settings


@pytest.mark.card
@pytest.mark.parametrize("sh_degree", [0, 3])
def test_card_kernels_match_the_plain_pair(card, sh_degree):
    import chip_smoke

    inputs, view, proj, settings = orbit_map(card, sh_coeffs=(sh_degree + 1) ** 2)
    res = chip_smoke.preprocess_check(inputs, view, proj, settings, sh_degree=sh_degree)
    chip_smoke.check_preprocess(res, f"orbit-shaped map, SH {sh_degree}")


@pytest.mark.card
def test_card_tracking_iteration_runs_the_kernels(card):
    import chip_smoke

    inputs, view, proj, settings = orbit_map(card)
    counts = chip_smoke.preprocess_tracking_counts(inputs, view, proj, settings, iters=3)
    assert counts["prep_fwd_plain"] == 0 and counts["prep_bwd_plain"] == 0, counts
    assert counts["iters"] >= 1, counts
    assert counts["prep_fwd_launches"] == counts["iters"] + 1, counts
    assert counts["prep_bwd_launches"] == counts["iters"], counts

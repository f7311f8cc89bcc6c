"""The yardstick's counts against hand counts on small shapes."""

import numpy as np
import pytest
import torch

from perfbench.harness import counts


def test_blend_bytes_forward_by_hand():
    # P = 10 Gaussians, 40 instances, C = 7, a 20 x 12 image in tiles of 8
    # (3 x 2 tiles): rows of 10 x (8 + 7) floats, 40 ids, 6 starts and 6
    # counts read; 7 channels, T and n_contrib per pixel and 10 n_touched
    # written.
    want = 10 * 15 * 4 + 40 * 4 + 12 * 4 + (7 + 2) * 240 * 4 + 10 * 4
    assert counts.blend_bytes("fwd", 10, 40, 7, 12, 20, 8) == want


def test_blend_bytes_backward_by_hand():
    # Rows of min(P, N) = 5 Gaussians (N = 5 < P = 10), ids, ranges, the
    # two cotangents and the two forward outputs, the emission order
    # (5 instance ids, 10 starts, 10 counts), and d_table's 10 x (6 + 4).
    want = (5 * 12 * 4 + 5 * 4 + 2 * 4 * 4 + (2 * 4 + 2) * 64 * 4 + 5 * 4 + 20 * 4
            + 10 * 10 * 4)
    assert counts.blend_bytes("bwd", 10, 5, 4, 8, 8, 4) == want


def test_blend_flops_and_bound():
    assert counts.blend_flops("fwd", 19, 100, 10) == 15 * 100 + (2 * 19 + 3) * 10
    assert counts.blend_flops("bwd", 4, 100, 10) == 15 * 100 + (4 * 4 + 31) * 10
    assert counts.bound_s(67e12, 1.0) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def _walk(geom, ids_per_tile, width, height, tile):
    """Brute force: every (instance, pixel) pair in order, in float64."""
    tiles_x = -(-width // tile)
    ev = co = 0
    for t, ids in enumerate(ids_per_tile):
        for py in range((t // tiles_x) * tile, min((t // tiles_x + 1) * tile, height)):
            for px in range((t % tiles_x) * tile, min((t % tiles_x + 1) * tile, width)):
                trans, stopped = 1.0, False
                for g in ids:
                    x, y, a, b, c, op = geom[g, :6]
                    dx, dy = x - px, y - py
                    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                    alpha = min(0.99, op * np.exp(power))
                    if stopped or power > 0 or alpha < 1 / 255:
                        continue
                    ev += 1
                    if trans * (1 - alpha) < 1e-4:
                        stopped = True
                        continue
                    co += 1
                    trans *= 1 - alpha
    return ev, co


def test_blend_work_against_a_brute_force_walk():
    rng = np.random.default_rng(0)
    p, width, height, tile = 30, 12, 9, 4
    geom = np.zeros((p, 8), np.float32)
    geom[:, 0] = rng.uniform(-2, width + 2, p)
    geom[:, 1] = rng.uniform(-2, height + 2, p)
    geom[:, 2] = geom[:, 4] = rng.uniform(0.05, 1.0, p)
    geom[:, 3] = rng.uniform(-0.02, 0.02, p)
    geom[:, 5] = rng.uniform(0.2, 0.99, p)
    tiles = (-(-width // tile)) * (-(-height // tile))
    per_tile = [sorted(rng.choice(p, rng.integers(0, p), replace=False).tolist())
                for _ in range(tiles)]
    s_gid = torch.tensor([g for ids in per_tile for g in ids], dtype=torch.int32)
    counts_t = torch.tensor([len(ids) for ids in per_tile], dtype=torch.int32)
    starts = torch.cumsum(counts_t, 0) - counts_t
    got = counts.blend_work(torch.from_numpy(geom), s_gid, starts, counts_t, width=width,
                            height=height, tile=tile, chunk=5)
    assert got == _walk(geom.astype(np.float64), per_tile, width, height, tile)


def test_extractor_flops_by_hand():
    cfg = {"clip_resolution": [64, 64], "depths": [1, 1], "dims": [4, 8], "embed_dim": 6,
           "clip_dim": 6, "ae_encoder": [3, 2]}
    macs = 16 * 16 * 4 * 3 * 16                               # stem at 16 x 16
    macs += 16 * 16 * (4 * 49 + 2 * 4 * 16)                   # block of width 4
    macs += 8 * 8 * 8 * 4 * 4 + 8 * 8 * (8 * 49 + 2 * 8 * 32)  # downsample, block of 8
    macs += 8 * 8 * (8 * 12 + 12 * 6)                         # head at 8 x 8
    hr = (8 * 8 * 512 * 6 * 9 + 16 * 16 * 512 * 512 * 4
          + 16 * 16 * (512 * 8 + 512 * 1024 * 9 + 512 * 512 * 9 + 512 * 512)
          + 32 * 32 * 256 * 512 * 4
          + 32 * 32 * (256 * 4 + 256 * 512 * 9 + 256 * 256 * 9 + 256 * 256)
          + 64 * 64 * 128 * 256 * 4 + 64 * 64 * 6 * 128)
    ae = 64 * 64 * (6 * 3 + 3 * 2)
    assert counts.extractor_flops(cfg) == 2.0 * (macs + hr + ae)


def test_extractor_flops_convnext_l_at_768():
    cfg = {"clip_resolution": [768, 768], "depths": [3, 3, 27, 3],
           "dims": [192, 384, 768, 1536], "embed_dim": 768, "clip_dim": 768,
           "ae_encoder": [384, 192, 96, 48, 24, 15]}
    assert 0.9e12 < counts.extractor_flops(cfg) < 1.0e12

"""The Replica label builders without OpenCV: connected components and
outer contours (eval/contours.py) against cv2.connectedComponents and
cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) with cv2.boundingRect
and cv2.contourArea, and both tools' outputs against the JAX package's
eval/create_replica_labels.py and eval/replica_save_labels.py (run by
path) on synthetic semantic PNGs, 8- and 16-bit. Everything here is
integer work, so every comparison is exact.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from online_lang_splatting_tpu_torch.eval.contours import (bounding_rect, connected_components,
                                                           contour_area, find_external_contours)
from online_lang_splatting_tpu_torch.tools import create_replica_labels, replica_save_labels
from online_lang_splatting_tpu_torch.utils.png import write_png

REPO = Path(__file__).resolve().parents[1]
# id -> name; 0, 95 and 126 are replica_save_labels' background ids,
# wall / floor / ceiling are create_replica_labels' ignored names.
CLASSES = {0: "undefined", 3: "chair", 7: "table", 12: "wall", 20: "lamp", 31: "floor",
           44: "sofa", 58: "vase", 95: "ceiling", 126: "rug", 200: "book", 301: "plant"}


def _script(rel: str):
    spec = importlib.util.spec_from_file_location("jax_labels_" + Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _blobs(rng, h, w, ids, n):
    """A label map of `n` overlapping ellipses and rectangles (some with
    holes, some touching the border) on id 0."""
    seg = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(n):
        cid = int(rng.choice(ids))
        cy, cx = rng.integers(-5, h + 5), rng.integers(-5, w + 5)
        ry, rx = rng.integers(2, max(h // 3, 3)), rng.integers(2, max(w // 3, 3))
        if rng.uniform() < 0.5:
            shape = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
            if rng.uniform() < 0.4:  # a ring
                shape &= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 > 0.3
        else:
            shape = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
        seg[shape] = cid
    return seg


def _masks(seed, count):
    rng = np.random.default_rng(seed)
    for k in range(count):
        h, w = (int(v) for v in rng.integers(6, 48, 2))
        if k % 2:
            yield (rng.uniform(size=(h, w)) < rng.uniform(0.05, 0.7)).astype(np.uint8)
        else:
            yield (_blobs(rng, h, w, [1, 2], 4) == 1).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_connected_components_match_opencv(seed):
    """8-connected labels numbered as cv2.connectedComponents numbers them."""
    import cv2

    for mask in _masks(seed, 150):
        n, lab = cv2.connectedComponents(mask)
        got_n, got = connected_components(mask)
        assert got_n == n
        np.testing.assert_array_equal(got, lab)


@pytest.mark.parametrize("seed", [2, 3])
def test_external_contours_match_opencv(seed):
    """Outer contours (points, order, count), bounding boxes and areas, on
    random masks and on blobs with holes and nested components."""
    import cv2

    for mask in _masks(seed, 150):
        ref, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        got = find_external_contours(mask)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r[:, 0])
            assert bounding_rect(g) == tuple(cv2.boundingRect(r))
            assert contour_area(g) == cv2.contourArea(r)


def test_read_gray8_and_polygon_to_mask_match_jax(tmp_path):
    """IMREAD_GRAYSCALE's 16 -> 8 bit reading (the high byte) and the
    labelme polygon fill of replica_save_labels."""
    import cv2

    jsave = _script("eval/replica_save_labels.py")
    rng = np.random.default_rng(4)
    for img in (rng.integers(0, 65536, (13, 17), dtype=np.uint16),
                rng.integers(0, 256, (13, 17), dtype=np.uint8)):
        write_png(tmp_path / "g.png", img)
        np.testing.assert_array_equal(replica_save_labels.read_gray8(tmp_path / "g.png"),
                                      cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_GRAYSCALE))
    polys = [rng.integers(-10, 50, (7, 2)).tolist(), rng.integers(0, 40, (4, 2)).tolist()]
    np.testing.assert_array_equal(replica_save_labels.polygon_to_mask((37, 41), polys),
                                  jsave.polygon_to_mask((37, 41), polys))


@pytest.fixture(scope="module")
def replica_scene(tmp_path_factory):
    """semantic_config.yaml and 20 semantic_class_{i}.png label maps (60 x
    80; frames 0-9 16-bit with an id above 255, 10-19 8-bit)."""
    import yaml

    root = tmp_path_factory.mktemp("replica")
    (root / "semantic_config.yaml").write_text(yaml.safe_dump(
        {"classes": [{"id": i, "name": name} for i, name in CLASSES.items()]}))
    (root / "semantic_class").mkdir()
    rng = np.random.default_rng(5)
    ids8 = [i for i in CLASSES if i < 256]
    for idx in range(20):
        wide = idx < 10
        seg = _blobs(rng, 60, 80, list(CLASSES) if wide else ids8, 9)
        write_png(root / "semantic_class" / f"semantic_class_{idx}.png",
                  seg.astype(np.uint16 if wide else np.uint8))
    return root


def test_create_replica_labels_matches_jax(replica_scene, tmp_path, monkeypatch):
    frames = "1,5,12,15,18"
    argv = ["--semantic-config", str(replica_scene / "semantic_config.yaml"),
            "--frames", frames, "--top-k", "6"]
    monkeypatch.setattr(sys, "argv", ["create_replica_labels.py", *argv,
                                      "--out", str(tmp_path / "j")])
    _script("eval/create_replica_labels.py").main()
    got = create_replica_labels.main([*argv, "--out", str(tmp_path / "p")])
    ref_text = (tmp_path / "j" / "ann.json").read_text()
    assert (tmp_path / "p" / "ann.json").read_text() == ref_text
    assert got == json.loads(ref_text) and len(got) >= 3
    assert any(q["bboxes"] for frame in got.values() for q in frame.values())
    names = sorted(p.name for p in (tmp_path / "j").glob("*.npy"))
    assert names == sorted(p.name for p in (tmp_path / "p").glob("*.npy")) and names
    for name in names:
        np.testing.assert_array_equal(np.load(tmp_path / "p" / name),
                                      np.load(tmp_path / "j" / name))


def test_replica_save_labels_matches_jax(replica_scene, tmp_path, monkeypatch):
    frames = "0,3,7,11,16,19"
    argv = ["--semantic-config", str(replica_scene / "semantic_config.yaml"),
            "--frames", frames, "--top-k", "8", "--scene-name", "room0"]
    monkeypatch.setattr(sys, "argv", ["replica_save_labels.py", *argv,
                                      "--out", str(tmp_path / "j")])
    _script("eval/replica_save_labels.py").main()
    written = replica_save_labels.main([*argv, "--out", str(tmp_path / "p")])
    names = sorted(p.name for p in (tmp_path / "j").glob("*.json"))
    assert names == sorted(p.name for p in (tmp_path / "p").glob("*.json"))
    assert len(names) == written == 6
    objects = 0
    for name in names:
        got = (tmp_path / "p" / name).read_text()
        assert got == (tmp_path / "j" / name).read_text(), name
        objects += len(json.loads(got)["objects"])
    assert objects > 2 * len(names)

"""The port's import rules, read from its sources: no module of the port
and not chip_smoke.py imports jax, the JAX package
(`online_lang_splatting_tpu` without `_torch`) or skimage. Two imports
have one site each: cv2 in `EuRoCDataset.__getitem__` of slam/datasets.py,
for the uint8 remap and SGBM of the stereo pair, which have no PyTorch
counterpart, and open3d in `SLAM_GUI.__init__` of gui/slam_gui.py, the
interactive window, which SLAM replaces by the headless viewer where
open3d is missing."""

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "online_lang_splatting_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "slam_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "online_lang_splatting_tpu", "skimage", "open3d")
CV2_SITE = ("online_lang_splatting_tpu_torch/slam/datasets.py", "EuRoCDataset.__getitem__")
OPEN3D_SITE = ("online_lang_splatting_tpu_torch/gui/slam_gui.py", "SLAM_GUI.__init__")


def _imports(path: Path):
    """(top-level module, enclosing 'Class.function' or '') of every import
    in a file; relative imports are the port's own."""
    tree = ast.parse(path.read_text())
    found = []

    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                walk(child, f"{scope}.{child.name}" if scope else child.name)
                continue
            if isinstance(child, ast.Import):
                found.extend((a.name.split(".")[0], scope) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and not child.level:
                found.append((child.module.split(".")[0], scope))
            walk(child, scope)

    walk(tree, "")
    return found


def test_port_imports_no_jax_skimage_open3d():
    """open3d outside its one site."""
    assert len(SOURCES) > 60
    bad = [(str(p.relative_to(REPO)), m) for p in SOURCES for m, scope in _imports(p)
           if m in FORBIDDEN and (m, (str(p.relative_to(REPO)), scope)) != ("open3d", OPEN3D_SITE)]
    assert not bad


def _sites(module: str):
    return [(str(p.relative_to(REPO)), scope) for p in SOURCES
            for m, scope in _imports(p) if m == module]


def test_cv2_only_at_the_sgbm_site():
    assert _sites("cv2") == [CV2_SITE]


def test_open3d_only_in_the_interactive_window():
    # Three imports there (open3d, its gui and rendering modules), one site.
    assert set(_sites("open3d")) == {OPEN3D_SITE}


def test_verify_artifacts_imports_torch_numpy_and_the_port_only():
    """The weight-port tool runs where neither JAX nor the tests are: its
    imports are the standard library's, torch, numpy and the port's own
    (relative) modules; nothing under tests/."""
    import sys

    path = REPO / "online_lang_splatting_tpu_torch/tools/verify_artifacts.py"
    modules = {m for m, _ in _imports(path)}
    assert {"torch", "numpy"} <= modules
    assert modules - set(sys.stdlib_module_names) == {"torch", "numpy"}
    tree = ast.parse(path.read_text())
    relative = [node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.level]
    assert relative and all(not (m or "").startswith("tests") for m in relative)

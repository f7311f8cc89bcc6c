"""The port's import rules, read from its sources: no module of the port
and not chip_smoke.py imports jax, the JAX package
(`online_lang_splatting_tpu` without `_torch`), skimage or open3d, and cv2
is imported in one place only: `EuRoCDataset.__getitem__` of
slam/datasets.py, for the uint8 remap and SGBM of the stereo pair, which
have no PyTorch counterpart."""

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "online_lang_splatting_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "slam_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "online_lang_splatting_tpu", "skimage", "open3d")
CV2_SITE = ("online_lang_splatting_tpu_torch/slam/datasets.py", "EuRoCDataset.__getitem__")


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
    assert len(SOURCES) > 60
    bad = [(str(p.relative_to(REPO)), m) for p in SOURCES for m, _ in _imports(p)
           if m in FORBIDDEN]
    assert not bad


def test_cv2_only_at_the_sgbm_site():
    sites = [(str(p.relative_to(REPO)), scope) for p in SOURCES
             for m, scope in _imports(p) if m == "cv2"]
    assert sites == [CV2_SITE]

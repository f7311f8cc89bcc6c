"""No file of the benchmark imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the references import nothing of the program."""

import ast
from pathlib import Path

from perfbench.harness import common

BENCH = common.BENCH_DIR


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = _imports(f) & set(common.FORBIDDEN)
        assert not bad, (f, bad)


def test_the_port_is_the_only_program_imported():
    seen = set()
    for f in BENCH.rglob("*.py"):
        seen |= _imports(f)
    assert "online_lang_splatting_tpu_torch" in seen
    assert "online_lang_splatting_tpu" not in seen


def test_references_import_nothing_of_the_program():
    """The references import torch, math and one another only."""
    for f in (BENCH / "reference").rglob("*.py"):
        names = _imports(f)
        assert "online_lang_splatting_tpu_torch" not in names, f
        assert names <= {"__future__", "math", "torch", "perfbench"}, (f, names)
        own = {n.module for n in ast.walk(ast.parse(f.read_text()))
               if isinstance(n, ast.ImportFrom) and (n.module or "").startswith("perfbench")}
        assert all(m.startswith("perfbench.reference") for m in own), (f, own)


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "online_lang_splatting_tpu_torch_x",
                        types.ModuleType("online_lang_splatting_tpu_torch_x"))
    assert "online_lang_splatting_tpu" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "online_lang_splatting_tpu.slam",
                        types.ModuleType("online_lang_splatting_tpu.slam"))
    assert common.forbidden_loaded() == ["online_lang_splatting_tpu"]

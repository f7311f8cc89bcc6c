"""BENCHMARK.json against the contract's rules on names and shapes, and
every name of it resolving to its files; a cell added as data only is
found."""

import json
import re
import shutil

import pytest

from perfbench.harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
MAN = common.manifest()


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16 and 1 <= len(MAN["per_layer"]) <= 128


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries(section, keys):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"])
        for k in ("why", "layer", "source"):
            if k in e:
                assert LINE.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics_sources_bounds_and_cells():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:  # each listed cell reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert (common.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    for w in MAN["workloads"]:
        c = common.cell(MAN, w["name"])
        assert any(m["name"] != "setup_s" for m in c["end_to_end"])
        assert c["per_layer"], w["name"]
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_every_name_resolves():
    for w in MAN["workloads"]:
        c = common.cell(MAN, w["name"])
        assert c["config"]["name"] == w["config"]
        assert c["config"]["system"] in ("slam", "extractor")
        assert c["limits"] and all(v > 0 for v in c["limits"].values())
        for m in c["per_layer"]:
            assert callable(common.metric_reader(m["name"]))
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("perfbench/") and (common.ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])


def test_a_cell_added_as_data_is_found(tmp_path):
    """A copy of the benchmark gains a cell by new files and entries only."""
    shutil.copytree(common.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((common.ROOT / "BENCHMARK.json").read_text())
    new = "slam_replicav2_lang15.fastorbit"
    man["workloads"].append({"name": new, "config": "slam_replicav2_lang15",
                             "traffic": "fastorbit", "chips": 1, "why": "a shorter orbit"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "slam_replicav2_lang15.orbit" in m.get("workloads", []):
            m["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    traffic = json.loads((common.BENCH_DIR / "traffic" / "orbit.json").read_text())
    (tmp_path / "perfbench" / "traffic" / "fastorbit.json").write_text(
        json.dumps(dict(traffic, trajectory_frames=40)))
    shutil.copy(common.BENCH_DIR / "limits" / "slam_replicav2_lang15.orbit.json",
                tmp_path / "perfbench" / "limits" / f"{new}.json")
    old_root, old_bench = common.ROOT, common.BENCH_DIR
    try:
        common.ROOT, common.BENCH_DIR = tmp_path, tmp_path / "perfbench"
        c = common.cell(common.manifest(tmp_path), new)
    finally:
        common.ROOT, common.BENCH_DIR = old_root, old_bench
    assert c["traffic"]["trajectory_frames"] == 40
    assert {m["name"] for m in c["end_to_end"]} == {"slam_fps", "setup_s"}
    assert "map_ms_per_iter" in {m["name"] for m in c["per_layer"]}

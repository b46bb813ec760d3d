"""BENCHMARK.json against the benchmark's contract, every name resolving to
its files, and the import rules of the harness and its reference."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "sdrbench.run"]
    assert BENCH["paths"] == ["sdrbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_budget_of_a_full_check_fits():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n


def test_configs_resolve_to_their_files_and_references():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("sdrbench/configs/") and (ROOT / c["file"]).is_file()
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert (ROOT / "sdrbench" / "reference" / f"{cfg['reference']['module']}.py").is_file()
        assert cfg["check"]["audio_peak_err_db"] < 0


def test_cells_resolve_to_config_and_traffic():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        tr = json.loads((ROOT / "sdrbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "sdrbench" / "traffic" / f"{tr['mode']}.py").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_resolve_and_every_cell_reports_enough():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and TEXT.match(m["layer"]) and m["moves"] in e2e
        assert (ROOT / "sdrbench" / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"], m["layer"])
    for w in cells:
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells) and m["name"] != "setup_s"]
        assert reported, w
        assert any(w in m["workloads"] for m in BENCH["per_layer"]), w


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "sdrbench").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "tpusdr"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "sdrbench" / "reference").rglob("*.py"):
        assert "tpusdr_torch" not in _imports(path), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    from sdrbench import run

    monkeypatch.setitem(sys.modules, "tpusdr_torchlike", sys)
    assert "tpusdr" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpusdr.ops", sys)
    assert run.forbidden_modules() == ["tpusdr"]

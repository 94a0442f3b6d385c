"""BENCHMARK.json against the benchmark's rules (keys, names, units, bounds,
the metrics each cell reports), and every file a cell is found by."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert _line(e["why"])
    for c in BENCH["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_entry_keys():
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for group, keys in allowed.items():
        for e in BENCH[group]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, (group, e["name"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_cells_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in {c["name"] for c in BENCH["configs"]}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        reported = [n for n, m in e2e.items() if _reports(m, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert any(_reports(m, w["name"]) for m in BENCH["per_layer"]), w["name"]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and _reports(moved, cell), (m["name"], cell)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    configs_used = {w["config"] for w in BENCH["workloads"]}
    assert configs_used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    from portbench.harness import cell as cells

    loaded = cells.load_cell(cell)
    assert loaded.cfg["name"] == cell.split(".")[0]
    assert set(loaded.limits) and loaded.family is not None and loaded.reference is not None
    for m in loaded.end_to_end + loaded.per_layer:
        assert callable(cells.reader(m["name"]))
    assert loaded.driver.MODE in ("train", "serve")
    o = loaded.cfg["optimizer"]
    for pkg, name in (("optimizers", o["name"]), ("schedules", o["scheduler"])):
        assert (PKG / pkg / f"{name}.py").is_file(), (pkg, name)


def test_config_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_paths_hold_only_the_benchmark():
    for p in PKG.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel

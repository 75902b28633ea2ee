"""BENCHMARK.json and every file it names: shapes the contract sets, and
every cell resolving to a driver, limits and metric readers."""
import json
import re
from importlib import import_module
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("path", sorted(
    (ROOT / "benchmark" / "configs").glob("*.json"))
    + sorted((ROOT / "benchmark" / "traffic").glob("*.json"))
    + sorted((ROOT / "benchmark" / "limits").glob("*.json")),
    ids=lambda p: f"{p.parent.name}/{p.name}")
def test_data_files_parse(path):
    assert isinstance(json.loads(path.read_text()), dict)


def test_configs():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert (ROOT / body["weights"]).exists()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    spec = harness.load_cell(cell, ROOT)
    w = spec["cell"]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] in (1, 4)
    assert len(w["why"]) <= 200
    driver = import_module(f"benchmark.drivers.{spec['traffic']['entry']}")
    for fn in ("setup", "window", "judge"):
        assert callable(getattr(driver, fn))
    assert all(isinstance(v, (int, float)) for v in spec["limits"].values())
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]


def test_metrics_have_readers():
    seen = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert callable(harness.reader(m["name"]))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}

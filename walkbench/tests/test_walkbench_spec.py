"""``BENCHMARK.json`` against its files and the benchmark's contract: every
cell, configuration, traffic mix and metric resolves to its file; names,
units, bounds and the run length stay inside their limits."""

import json
import re
from pathlib import Path

import pytest

from walkbench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}  # fmt: skip
    assert SPEC["paths"] == ["walkbench"]
    assert SPEC["command"] == ["python3", "walkbench/run.py"]
    assert (ROOT / SPEC["command"][1]).is_file()
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_and_reports_what_it_must(cell):
    c = harness.resolve_cell(cell)
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert cell == f"{w['traffic']}.{w['config']}"
    assert c.chips == 1 and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_configurations_are_files_under_paths_with_their_cuts():
    files = set()
    for entry in SPEC["configs"]:
        path = ROOT / entry["file"]
        assert entry["file"].startswith("walkbench/configs/") and path.is_file()
        files.add(entry["file"])
        config = json.loads(path.read_text())
        assert config["name"] == entry["name"] and config["source"] == entry["source"]
        assert sorted(entry["reduced"]) == sorted(r["key"] for r in config["reduced"])
        for key in entry["reduced"]:
            assert key in config and NAME.match(key)
        assert any(w["config"] == entry["name"] for w in SPEC["workloads"])
    assert len(files) == len(SPEC["configs"])


def test_traffic_mixes_are_data_files():
    for traffic in {w["traffic"] for w in SPEC["workloads"]}:
        data = json.loads((ROOT / "walkbench" / "traffic" / f"{traffic}.json").read_text())
        assert data["name"] == traffic


def test_metrics_resolve_to_readers_and_name_existing_cells():
    seen = set()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert callable(harness.metric_reader(m["name"]))
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m and "\n" not in m["layer"]
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_is_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)

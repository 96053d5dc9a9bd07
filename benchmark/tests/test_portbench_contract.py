"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, the run length's budget, and that every file a cell, a
configuration or a metric is found by exists under the benchmark's path."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", _metrics() + BENCH["workloads"] + BENCH["configs"], ids=lambda e: e["name"])
def test_names_and_units_use_the_allowed_characters(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique():
    for group in (_metrics(), BENCH["workloads"], BENCH["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics(metric):
    assert set(metric) - {"workloads"} == METRIC_KEYS
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_an_end_to_end_metric_of_its_cells(metric):
    assert set(metric) - {"workloads"} == LAYER_KEYS
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in metric.get("workloads", cells):
        assert cell in cells
        assert cell in e2e[metric["moves"]].get("workloads", cells)
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", []) for m in BENCH["per_layer"])
    assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").is_file()
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_has_a_file_of_its_own_under_the_paths(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"]
    assert sum(c["file"] == config["file"] for c in BENCH["configs"]) == 1


def test_a_full_check_fits_its_budget_with_all_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_are_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)

"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found and loaded by name."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from imbue_bench import harness
from imbue_bench.tests.tiny import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert MANIFEST["paths"] == ["imbue_bench"]
    assert MANIFEST["command"] == ["python3", "imbue_bench/run.py"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)
    for entry in MANIFEST["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(entry["name"])
    for entry in MANIFEST["workloads"]:
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] == 1
        assert len(entry["why"]) <= 200
        assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    e2e = [m for m in MANIFEST["end_to_end"] if harness.applies(m, cell)]
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = [m for m in MANIFEST["per_layer"] if harness.applies(m, cell)]
    assert layer
    for m in layer:
        assert m["moves"] in names, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    cell_entry, config, traffic = harness.resolve(ROOT, MANIFEST, cell)
    assert config["name"] == cell_entry["config"]
    importlib.import_module(f"imbue_bench.reference.{config['reference']}")
    assert hasattr(harness.kind_module(traffic), "Cell")


@pytest.mark.parametrize("name", [m["name"] for m in MANIFEST["per_layer"]])
def test_every_reader_loads(name):
    assert callable(harness.load_reader(ROOT, MANIFEST, name).read)


@pytest.mark.parametrize("name,cells", [("imbue-tm-mnist", 3_136_000),
                                        ("imbue-tm-kmnist", 7_840_000)])
def test_configs_hold_table_iv(name, cells):
    """Each configuration's file holds the paper's widths: its TA cells
    are Table IV's, and nothing is reduced."""
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    entry = {c["name"]: c for c in MANIFEST["configs"]}[name]
    assert entry["file"] == f"imbue_bench/configs/{name}.json"
    assert entry["reduced"] == conf["reduced"] == []
    assert conf["n_classes"] * conf["clauses_per_class"] * 2 * conf[
        "n_features"] == cells


def test_paths_hold_the_benchmark_alone():
    tracked = [p for p in BENCH.rglob("*") if p.is_file()
               and "__pycache__" not in p.parts]
    for p in tracked:
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel

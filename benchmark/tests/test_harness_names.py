"""Every name in BENCHMARK.json finds its files, and the manifest keeps to
the benchmark's rules on names, units and shapes."""

import json
import re

import pytest

import helpers
from benchlib import runner

BENCH = json.loads((helpers.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    entry, config, traffic = runner.cell_files(cell, BENCH)
    assert config["name"] == entry["config"]
    # a mix may name a driver of its own (a new way to serve a
    # configuration); else the configuration's
    assert hasattr(runner.driver(traffic.get("driver", config["driver"])),
                   "build")
    from reference import module

    for m in config["modules"]:
        assert hasattr(module(m), "Module")
        assert m in config["knobs"]
    assert int(traffic["streams"]) >= 1 and "check" in traffic
    layer = [m for m in BENCH["per_layer"]
             if cell in m.get("workloads", [cell])]
    assert layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_finds_its_reader(metric):
    assert callable(runner.reader(metric).read)
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_per_layer_metrics_move(cell):
    """A cell reports the set-up time and another end-to-end metric, and
    every end-to-end metric its per-layer metrics name as the one they
    move."""
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", CELLS)}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", CELLS):
            assert m["moves"] in e2e, (cell, m["name"])


def test_a_quantity_split_by_cells_reads_with_its_quantitys_reader():
    assert (runner.reader("fetch_ms.fleet").__file__
            == runner.reader("fetch_ms").__file__)
    with pytest.raises(FileNotFoundError):
        runner.reader("no_such_metric.fleet")


def test_config_files_lie_under_paths_and_differ():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("benchmark/") for f in files)


def test_file_names_under_paths_use_name_characters():
    for p in helpers.BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(helpers.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        runner.cell_files("no_such.cell", BENCH)
    with pytest.raises(FileNotFoundError):
        runner.reader("no_such_metric")
    from reference import module

    with pytest.raises(ValueError):
        module("../run")

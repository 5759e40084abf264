"""Shared by the benchmark's tests: the harness on the path, and a cell cut
to a size a CPU test run can hold (small frames, a few streams, short
windows; bufsize and every other DSP setting as the cell runs them)."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import runner  # noqa: E402

SEED = 2**31 + 77


def tiny(cell_name: str, streams: int = 8) -> tuple:
    """(cell, config, traffic, devices) of ``cell_name`` at 96x64 with
    at most ``streams`` streams, on the CPU."""
    entry, config, traffic = runner.cell_files(cell_name)
    config = copy.deepcopy(config)
    config["requests"] = config["requests"] + ["setgeometry 0 0 96 64"]
    config["geometry"] = [96, 64]
    traffic = copy.deepcopy(traffic)
    if traffic["streams"] > 1:
        traffic["streams"] = streams
        traffic["check"] = {"streams": 8, "frames": 2}
    traffic["warmup_s"] = 0.4
    return entry, config, traffic, ["cpu"]


def run(cell_name: str, seconds: float = 2.5, control: bool = False,
        seed: int = SEED, trace: bool = False) -> dict:
    """One whole run of the cell at the tiny size, reading the per-layer
    metrics BENCHMARK.json gives the cell; a window of 2.5 s holds two
    ticks of the loop's measured update rate."""
    entry, config, traffic, devices = tiny(cell_name)
    per_layer = [m for m in runner.manifest()["per_layer"]
                 if cell_name in m.get("workloads", [cell_name])]
    return runner.run_cell(entry, config, traffic, seed, seconds, trace,
                           devices, time.perf_counter(), control=control,
                           per_layer=per_layer)

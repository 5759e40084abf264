"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload rc_bars.live --seed 7 --seconds 20 --trace 0

Loads the cell named in BENCHMARK.json (its configuration, traffic mix
and driver, found by name), makes the inputs from the seed, builds the
port (``glava_tpu_torch``) on the cards the cell asks for, warms it up,
measures for ``--seconds``, checks the frames against the plain
reference, and prints one JSON object as the last line of standard
output; the compared numbers and their limits are the last lines of
standard error. ``--trace 1`` measures the per-layer metrics instead of
the end-to-end ones. ``--control 1`` also reads the check's control
(the reference one step of precision lower in the program's place).
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be positive")
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from benchlib import cores

    # before torch starts its threads and the driver's
    pins = cores.split()
    import torch

    from benchlib import runner

    bench = runner.manifest()
    cell, config, traffic = runner.cell_files(args.workload, bench)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {cell['name']} needs {chips} CUDA device(s), "
              f"{have} visible", file=sys.stderr)
        return 2
    per_layer = [m for m in bench["per_layer"]
                 if cell["name"] in m.get("workloads", [cell["name"]])]
    end_to_end = [m for m in bench["end_to_end"]
                  if cell["name"] in m.get("workloads", [cell["name"]])]
    devices = [f"cuda:{i}" for i in range(chips)]
    try:
        out = runner.run_cell(cell, config, traffic, args.seed, args.seconds,
                              bool(args.trace), devices, T_PROC,
                              per_layer=per_layer, control=bool(args.control),
                              pins=pins, end_to_end=end_to_end)
    except runner.JaxLoaded as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    print(f"benchmark: stream frames handed off in each second of the "
          f"window: {out['by_second']}; the loop's thread ran on a CPU "
          f"{out['loop_cpu_share']:.3f} of the window; the check took "
          f"{out['reference_s']:.1f} s; cores {pins}", file=sys.stderr)
    parts = ", ".join(f"{k} {v:.2f} s" for k, v in out["setup_parts"].items())
    print(f"benchmark: set-up {parts}", file=sys.stderr)
    # what the check and the metric readers imported after the window
    # counts too: the process that prints the result holds no JAX
    found = runner.jax_loaded()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(out["line"]), flush=True)
    for name, (value, limit) in out["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

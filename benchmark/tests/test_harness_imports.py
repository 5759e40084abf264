"""What the benchmark loads, by whole top-level module name: the harness
and a cell's modules load neither JAX nor the JAX package (``glava_tpu``,
a prefix of the port's own name ``glava_tpu_torch``); the reference loads
nothing of the port either. And without a card a run prints no result."""

import json
import subprocess
import sys

import pytest

import helpers

FORBIDDEN = ("jax", "jaxlib", "flax", "glava_tpu")


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=helpers.ROOT, capture_output=True, text=True, timeout=300,
        check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


PATH = (f"import sys; sys.path[:0] = [{str(helpers.BENCH)!r}, "
        f"{str(helpers.ROOT)!r}]\n")


def test_harness_and_cells_load_no_jax():
    cells = [w["name"] for w in json.loads(
        (helpers.ROOT / "BENCHMARK.json").read_text())["workloads"]]
    code = PATH + (
        "from benchlib import runner, live, check, trace, system\n"
        "bench = runner.manifest()\n"
        f"for c in {cells!r}:\n"
        "    cell, config, traffic = runner.cell_files(c, bench)\n"
        "    runner.driver(config['driver'])\n"
        "for m in bench['per_layer']:\n"
        "    runner.reader(m['name'])\n"
        "import glava_tpu_torch.runtime.engine, glava_tpu_torch.runtime.fleet\n")
    mods = _loaded(code)
    assert "glava_tpu_torch" in mods           # the port did load
    assert not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


def test_the_whole_top_level_name_is_compared():
    sys.modules.setdefault("glava_tpu_torch_probe", sys)
    from benchlib import runner

    assert "glava_tpu" not in runner.jax_loaded()
    del sys.modules["glava_tpu_torch_probe"]


def test_reference_loads_nothing_of_the_port():
    code = PATH + (
        "import numpy as np, torch\n"
        "from benchlib import pcm, check, roofline, stats\n"
        "from reference import dsp, gravity, module\n"
        "for m in ('bars', 'radial', 'circle', 'wave'):\n"
        "    module(m)\n"
        "sp = dsp.Spectra(2, {'bufsize': 256, 'avg_frames': 5,\n"
        "    'avg_window': True, 'fft_scale': 10.2, 'fft_cutoff': 0.3,\n"
        "    'smooth_factor': 0.025}, 'cpu')\n"
        "x = torch.as_tensor(pcm.make_pcm(3, 1, 256, 22050)[0])\n"
        "sp.update(torch.arange(2), x, torch.full((2,), 0.05))\n"
        "sp.textures(torch.arange(2))\n")
    mods = _loaded(code)
    assert not mods & set(FORBIDDEN + ("glava_tpu_torch",)), mods


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "rc_bars.live",
         "--seed", str(helpers.SEED), "--seconds", "1", "--trace", "0"],
        cwd=helpers.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("plant", [False, True], ids=["clean", "reader-loads-jax"])
def test_a_reader_that_loads_jax_stops_the_result(plant, monkeypatch, capsys):
    """``run.py`` looks at ``sys.modules`` again just before it prints:
    a metric reader (run after the window) that loads ``jax`` leaves no
    result line and a non-zero exit; the same run without it prints."""
    import importlib.util
    import types

    import torch

    from benchlib import cores, runner

    assert not runner.jax_loaded()
    spec = importlib.util.spec_from_file_location("bench_run_main",
                                                  helpers.BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setattr(cores, "split", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    entry, config, traffic, devices = helpers.tiny("rc_bars.live")
    real_cell, real_reader = runner.run_cell, runner.reader
    monkeypatch.setattr(runner, "run_cell", lambda c, cf, tr, seed, seconds, trace, d, t, **kw: real_cell(
        entry, config, traffic, seed, seconds, trace, devices, t, **kw))

    class Planted:
        @staticmethod
        def read(ctx):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return None

    monkeypatch.setattr(runner, "reader", lambda name: (
        Planted if plant and name == "snapshot_ms" else real_reader(name)))
    rc = run.main(["--workload", "rc_bars.live", "--seed", str(helpers.SEED),
                   "--seconds", "1", "--trace", "1"])
    out = capsys.readouterr()
    if plant:
        assert rc != 0 and out.out.strip() == "", out.out[-500:]
        assert "jax" in out.err
    else:
        assert rc == 0, out.err[-2000:]
        assert json.loads(out.out.strip().splitlines()[-1])["correct"]

"""The port's benchmark (``glava_tpu_torch.bench``) and timers
(``glava_tpu_torch.utils.timing``) on the CPU.

``flops_per_window`` must equal the JAX bench's
``_chain_flops_per_window`` exactly, with the presmooth dense (bufsize
1024) and block-banded (4096, 16384). Every section runs at a tiny size
and returns its keys of the line with finite positive numbers; the keys
that name device time are ``null`` on the CPU, which measures no
device. Every CUDA timer and ``--device cuda`` raise without a card.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import shutil
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch

import bench as jax_bench
from glava_tpu.config import loader as jloader
from glava_tpu.ops import autotune
from glava_tpu.pipeline import AudioPipeline as JaxPipeline
from glava_tpu.pipeline import UniformSpec as JaxUniform
from glava_tpu_torch import bench
from glava_tpu_torch.config import loader
from glava_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
RINGS = ROOT / "docs" / "examples" / "rings"
SMALL = (64, 48)
# device time: measured only on a card
DEVICE_KEYS = {"device_step_ms", "device_p50_pcm_to_frame_ms",
               "pct_fp64_peak_algorithmic", "pct_hbm_peak", "peak"}


@pytest.mark.parametrize("bufsize", [1024, 4096, 16384])
def test_flops_per_window_equals_jax_count(bufsize, monkeypatch):
    monkeypatch.setattr(autotune, "_cache", {})   # no tuned presmooth form
    reqs = ("setgeometry 0 0 512 256", "setprintframes false")
    jcfg = replace(jloader.load(cli_requests=reqs, force_module="bars").cfg,
                   bufsize=bufsize)
    jpipe = JaxPipeline(jcfg, [JaxUniform("audio_l", "audio_l", bench.CHAIN),
                               JaxUniform("audio_r", "audio_r", bench.CHAIN)])
    cfg = loader.load(cli_requests=reqs, force_module="bars").cfg
    pipe = bench._stereo_pipe(cfg, bufsize, "cpu")
    banded = pipe.presmooth.banded is not None
    assert banded == (jpipe.presmooth.banded is not None) == (bufsize > 1024)
    assert bench.flops_per_window(pipe) == jax_bench._chain_flops_per_window(
        jpipe)


def _check(line: dict, allow_none=DEVICE_KEYS) -> None:
    """Every number finite and positive; ``None`` only under a key of
    device time."""
    for key, v in line.items():
        if v is None:
            assert key in allow_none, key
        elif isinstance(v, dict):
            _check(v, allow_none)
        elif not isinstance(v, str):
            assert math.isfinite(v) and v > 0, (key, v)


SECTIONS = {
    "bars": (bench.bars_frames, dict(streams=2, frames=2, screen=SMALL),
             {"bars_fps_per_stream_512x256", "total_fps_64streams",
              "device_step_ms"}),
    "modules": (bench.modules_1080p, dict(screen=SMALL, frames=2, builds=2),
                {"radial_1080p_fps", "circle_1080p_fps", "graph_1080p_fps",
                 "wave_1080p_fps"}),
    "fleet": (bench.heterogeneous_fleet, dict(streams=4, frames=2,
                                              screen=SMALL, reps=2),
              {"heterogeneous_fleet_64"}),
    "bufsize": (bench.bufsize_scaling, dict(bufsizes=(8192, 16384), streams=2,
                                            updates=2),
                {"bufsize_scaling"}),
    "saturated": (bench.saturated, dict(streams=4, updates=2, fleet_streams=4,
                                        fleet_frames=1, screen=SMALL, reps=1),
                  {"saturated"}),
    "device_p50": (bench.device_p50, dict(steps=2, readings=1),
                   {"device_p50_pcm_to_frame_ms"}),
    "logmel": (bench.logmel, dict(frames=16, passes=2),
               {"logmel_frames_per_s"}),
    "single_dispatch": (bench.single_dispatch, dict(samples=3, screen=SMALL),
                        {"p50_pcm_to_frame_ms_single_dispatch"}),
}


@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_section_at_a_tiny_size_on_the_cpu(name):
    fn, kw, keys = SECTIONS[name]
    line = fn(device="cpu", **kw)
    assert set(line) == keys
    _check(line)
    for k in keys & DEVICE_KEYS:
        assert line[k] is None          # a cpu run measures no device


def test_sections_give_every_key_of_the_line():
    keys = {"streams", "bufsize", "fused_kernel", "roofline",
            "interpreted_verbatim_1080p_fps"}
    for _, _, k in SECTIONS.values():
        keys |= k
    assert keys == set(bench.EXTRA_KEYS)


def test_module_stats_cover_every_build():
    stats = bench.module_fps("radial", ("setsamplerate 44100",), device="cpu",
                             screen=SMALL, frames=2, builds=3)
    assert stats["builds"] == 3
    assert stats["min"] <= stats["median"] <= stats["best"]


def test_windows_and_roofline_on_the_cpu():
    w, pipe = bench.windows("cpu", streams=2, updates=2)
    assert set(w) == {"windows_per_s", "streams", "bufsize", "fused_kernel"}
    assert (w["streams"], w["bufsize"], w["fused_kernel"]) == (2, 4096,
                                                               pipe.route)
    assert pipe.route == "kernel"
    _check(w)
    roof = bench.roofline(pipe, w["windows_per_s"], 2, "cpu")
    _check(roof)
    assert roof["peak"] is None and roof["pct_fp64_peak_algorithmic"] is None
    assert roof["flops_per_window"] == bench.flops_per_window(pipe)
    assert roof["bytes_per_window"] == timing.update_bytes(
        4096, 4, pipe.cfg.avg_frames) / 2
    card = bench.roofline(pipe, 1e6, 64, "cpu", 700.0)
    assert math.isclose(card["achieved_gflops_algorithmic"],
                        1e6 * roof["flops_per_window"] / 1e9)


def test_interpreted_section_runs_a_module_directory(tmp_path):
    shutil.copytree(RINGS, tmp_path / "rings")
    stats = bench.interpreted(tmp_path / "rings", device="cpu", screen=SMALL,
                              frames=2, builds=1)
    assert set(stats) == {"min", "median", "best", "builds"}
    _check(stats)


def test_interpreted_verbatim_is_null_and_names_the_missing_path(tmp_path,
                                                                 capsys):
    line = bench.interpreted_verbatim("cpu", reference=tmp_path)
    assert line == {"interpreted_verbatim_1080p_fps": None}
    err = capsys.readouterr().err
    assert str(tmp_path / "bars") in err and str(tmp_path / "circle") in err


def test_verbatim_shaders_are_read_from_inside_the_repository():
    assert bench.REFERENCE_SHADERS == ROOT / "reference" / "shaders" / "glava"
    default = inspect.signature(bench.interpreted_verbatim).parameters[
        "reference"].default
    assert default == bench.REFERENCE_SHADERS


def test_windows_spread_on_the_cpu():
    spread = bench.windows_spread("cpu", lengths=(1, 2), warmups=(1, 2),
                                  readings=2, streams=2, screen=SMALL)
    assert list(spread) == [f"{n} updates after {w} warm-up"
                            for w in (1, 2) for n in (1, 2)]
    for stats in spread.values():
        _check(stats)
        assert stats["min"] <= stats["median"] <= stats["max"]
        assert stats["max_over_min"] >= 1.0


def test_power_limit_is_the_card_of_the_uuid():
    smi = ("GPU-aaaa-1111, NVIDIA H100 80GB HBM3, 700.00 W\n"
           "GPU-bbbb-2222, NVIDIA H100 80GB HBM3, 500.00 W\n")
    assert bench.power_limit_w(smi, "bbbb-2222") == 500.0
    assert bench.power_limit_w(smi, "GPU-aaaa-1111") == 700.0
    with pytest.raises(RuntimeError, match="cccc"):
        bench.power_limit_w(smi, "cccc-3333")


def test_run_names_the_cpu_and_main_prints_one_line_last():
    line = bench.run(("logmel",), "cpu")
    assert (line["device"], line["power_limit_w"], line["value"]) == (
        "cpu", None, None)
    assert set(line["extra"]) == {"logmel_frames_per_s"}
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-m", "glava_tpu_torch.bench",
                           "--device", "cpu", "logmel"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip().splitlines()
    assert len(out) == 1
    assert json.loads(out[0])["metric"] == "fft_windows_per_sec_per_chip"
    assert "log-mel" in proc.stderr


def test_unknown_section_raises():
    with pytest.raises(ValueError, match="unknown bench sections"):
        bench.run(("nosuch",), "cpu")


def test_host_ms_times_every_call_after_a_warm_up():
    calls = []
    ms = timing.host_ms(calls.append, 3, "cpu")
    assert calls == [0, 0, 1, 2] and ms >= 0


def test_host_ms_takes_its_warm_up_count_and_a_list_of_devices():
    calls = []
    ms = timing.host_ms(calls.append, 2, ["cpu", "cpu"], warmup=3)
    assert calls == [0, 0, 0, 0, 1] and ms >= 0
    calls.clear()
    timing.host_ms(calls.append, 2, "cpu", warmup=0)
    assert calls == [0, 1]
    timing.synchronize(["cpu"])    # a cpu device has nothing to wait for


def test_cuda_timers_and_bench_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for timer in (lambda: timing.cuda_ms(lambda: None, 1),
                  lambda: timing.event_ms(lambda i: None, 1),
                  lambda: timing.device_ms(lambda: None, 1),
                  lambda: timing.kernel_ms(lambda: None, ("k",), 1),
                  lambda: timing.host_ms(lambda i: None, 1, "cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            timer()
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--device", "cuda", "logmel"])

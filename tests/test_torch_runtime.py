"""The port's host runtime: offline rendering and sinks, against the
JAX package. Frames meet the golden rule (under 0.2% of pixels more
than 2 LSB apart); host-side byte formats must be identical."""

from __future__ import annotations

import io
import wave

import numpy as np
import pytest
import torch

from glava_tpu.config import loader as jloader
from glava_tpu.renderer import yuv420_pack_host as jyuv420
from glava_tpu.runtime.offline import render_wav as jrender_wav
from glava_tpu_torch.config import loader
from glava_tpu_torch.renderer import yuv420_pack_host
from glava_tpu_torch.runtime import sinks
from glava_tpu_torch.runtime.offline import render_wav

REQS = ("setgeometry 0 0 64 48", "setbufsize 1024", "setsamplesize 256",
        "setprintframes false")


def _write_wav(path, seconds=0.35, rate=22050):
    t = np.arange(int(seconds * rate)) / rate
    left = 0.4 * np.sin(2 * np.pi * 300.0 * t) * (t < 0.2)
    right = 0.4 * np.sin(2 * np.pi * 2500.0 * t)
    pcm = (np.stack([left, right], axis=1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def test_offline_render_matches_jax(tmp_path):
    wav = tmp_path / "tone.wav"
    _write_wav(wav)
    got, want = [], []
    n = render_wav(loader.load(cli_requests=REQS, force_module="bars"),
                   str(wav), sinks.CallbackSink(lambda f, t: got.append(f)),
                   fps=60.0, device="cpu")
    jn = jrender_wav(jloader.load(cli_requests=REQS, force_module="bars"),
                     str(wav), sinks.CallbackSink(lambda f, t: want.append(f)),
                     fps=60.0, chunk=32)
    assert n == jn == len(got) == len(want) > 10
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape == (48, 64, 4)
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert float((diff > 2).mean()) < 0.002
    assert any((f[..., 3] > 0).any() for f in got)


def test_offline_render_cpu_path_matches_jax(tmp_path):
    """``setaccelfft false`` with ``setinterpolate`` on: the offline
    schedule's interpolation phase feeds the CPU path's keyframe blend
    every frame, as in the JAX ``render_wav``. 86 updates a second
    (hop 256) under 240 frames: phases 0.36, 0.72 and 1."""
    wav = tmp_path / "tone.wav"
    _write_wav(wav)
    reqs = REQS + ("setsamplesize 1024", "setaccelfft false",
                   "setinterpolate true")
    got, want = [], []
    n = render_wav(loader.load(cli_requests=reqs, force_module="bars"),
                   str(wav), sinks.CallbackSink(lambda f, t: got.append(f)),
                   fps=240.0, device="cpu")
    jn = jrender_wav(jloader.load(cli_requests=reqs, force_module="bars"),
                     str(wav), sinks.CallbackSink(lambda f, t: want.append(f)),
                     fps=240.0, chunk=32)
    assert n == jn == len(got) == len(want) > 20
    for a, b in zip(got, want):
        diff = np.abs(a.astype(np.int16) - np.asarray(b).astype(np.int16))
        assert float((diff > 2).mean()) < 0.002
    assert any((f[..., 3] > 0).any() for f in got)


def test_yuv420_host_pack_matches_jax():
    frame = np.random.default_rng(0).integers(0, 256, (8, 12, 4), np.uint8)
    for a, b in zip(yuv420_pack_host(frame), jyuv420(frame)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("spec", ["y4m", "raw"])
def test_stream_sinks_write_port_frames(spec):
    from glava_tpu_torch.renderer import Renderer

    r = Renderer(loader.load(cli_requests=REQS, force_module="bars"), device="cpu")
    snap = np.random.default_rng(1).standard_normal((2, 1024)).astype(np.float32)
    _, frame = r.step_u8(r.init_state(), torch.as_tensor(snap * 0.3), True,
                         0.0, 1.0, 0.05)
    buf = io.BytesIO()
    sink = sinks.Y4MSink(buf) if spec == "y4m" else sinks.RawSink(buf)
    sink.submit(frame.numpy(), 0.0)
    sink.close()
    data = buf.getvalue()
    if spec == "y4m":
        assert data.startswith(b"YUV4MPEG2 W64 H48")
        assert len(data.split(b"FRAME\n", 1)[1]) == 64 * 48 * 3 // 2
    else:
        assert data == frame.numpy().tobytes()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_run_tests_passes(device):
    """``--run-tests`` loads test_rc.glsl (the `test` module) and its
    one frame meets `settesteval` within +-0.5/255."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from glava_tpu_torch import cli

    assert cli.main(["--device", device, "--run-tests", "--sink", "null"]) == 0


@pytest.mark.parametrize("module", ["radial", "circle", "wave", "graph"])
def test_engine_drives_every_module_on_cpu(module):
    """``-m <module>`` through the Engine: frames render, and the CPU
    path launches neither kernel."""
    from glava_tpu_torch.ops import fused, lookup
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import LatestFrameSink

    sink = LatestFrameSink()
    eng = Engine(EngineOptions(device="cpu", audio_backend="synth",
                               force_module=module, requests=(
        "setgeometry 0 0 64 48", "setbufsize 1024", "setsamplesize 256",
        "setprintframes false")), sink=sink)
    before = (fused.launches, lookup.launches)
    eng.run(max_frames=6)
    assert eng.frames_rendered == 6
    assert (fused.launches, lookup.launches) == before
    frame = sink.latest()
    assert frame.shape == (48, 64, 4) and frame.dtype.name == "uint8"

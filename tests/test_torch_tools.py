"""The port's config tool, profiling helpers and log-mel frontend.

``glava_tpu_torch.config_tool`` is driven as tests/test_config_tool.py
drives the JAX one, and its output compared with the JAX tool's on the
same arguments; ``utils.profiling``'s trace with the program's spans
in it (tests/test_torch_spans.py holds the recorder); ``models.mel``
against ``glava_tpu.models.mel`` on the same numpy inputs, within 2e-5
of the peak (tests/test_mel.py).
"""

from __future__ import annotations

import io
import json
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from glava_tpu import config_tool as jconfig_tool
from glava_tpu.models import mel as jmel
from glava_tpu_torch import config_tool
from glava_tpu_torch.models import mel
from glava_tpu_torch.utils import profiling


def run(capsys, *argv, tool=config_tool):
    rc = tool.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


# ---------------------------------------------------------------------------
# config tool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [("modules",), ("requests",), ("show",),
                                  ("knobs", "bars"), ("knobs", "radial"),
                                  ("get", "graph", "COLOR")])
def test_config_tool_output_matches_jax(argv, tmp_path, capsys):
    """Every read-only subcommand prints what the JAX tool prints."""
    flag = ("--config-dir", str(tmp_path))
    got = run(capsys, *flag, *argv)
    want = run(capsys, *flag, *argv, tool=jconfig_tool)
    assert got == want and got[0] == 0 and got[1]


def test_config_tool_knobs_set_get_roundtrip(tmp_path, capsys):
    rc, out, _ = run(capsys, "--config-dir", str(tmp_path),
                     "set", "bars", "BAR_WIDTH", "8")
    assert rc == 0 and "BAR_WIDTH" in out
    rc, out, _ = run(capsys, "--config-dir", str(tmp_path),
                     "get", "bars", "BAR_WIDTH")
    assert rc == 0 and out.strip() == "8"
    rc, out, _ = run(capsys, "--config-dir", str(tmp_path), "knobs", "bars")
    assert rc == 0 and "BAR_WIDTH = 8   [user]" in out
    rc, _, err = run(capsys, "--config-dir", str(tmp_path),
                     "get", "bars", "NO_SUCH_KNOB")
    assert rc == 1 and "not found" in err
    # the edit is what the port's loader reads
    from glava_tpu_torch.config import loader

    lc = loader.load(user_dir=str(tmp_path), force_module="bars")
    assert float(lc.env.lookup("BAR_WIDTH")) == 8.0


def test_config_tool_profiles_and_install(tmp_path, capsys, monkeypatch):
    rc, out, _ = run(capsys, "--config-dir", str(tmp_path), "profile", "new", "work")
    assert rc == 0 and "glava-tpu-torch --config-dir" in out
    assert (tmp_path / "profiles" / "work" / "rc.glsl").is_file()
    rc, out, _ = run(capsys, "--config-dir", str(tmp_path), "profile", "list")
    assert rc == 0 and out.split() == ["work"]
    rc, out, _ = run(capsys, "--config-dir", str(tmp_path), "profile", "copy", "w2")
    assert rc == 0 and (tmp_path / "profiles" / "w2").is_dir()
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    rc, out, _ = run(capsys, "install")
    assert rc == 0
    assert (tmp_path / "home" / ".config" / "glava_tpu" / "rc.glsl").is_file()


def test_config_tool_lists_user_shader_modules(tmp_path, capsys):
    (tmp_path / "rings").mkdir()
    (tmp_path / "rings" / "1.frag").write_text("void main() {}\n")
    rc, out, _ = run(capsys, "--config-dir", str(tmp_path), "modules")
    assert rc == 0 and "rings (user GLSL" in out


def test_config_tool_interactive_session(tmp_path, capsys):
    """tests/test_config_tool.py's piped session, on the port's tool."""
    script = io.StringIO("help\nmodules\nuse bars\nset BAR_WIDTH 9\n"
                         "get BAR_WIDTH\nbogus\nknobs\nquit\n")

    class Args:
        config_dir = str(tmp_path)

    rc = config_tool.cmd_interactive(Args(), stdin=script)
    out = capsys.readouterr()
    assert rc == 0
    assert "commands:" in out.out and "bars" in out.out
    assert "set BAR_WIDTH = 9" in out.out and "\n9\n" in out.out
    assert "unknown command 'bogus'" in out.err
    assert "BAR_WIDTH = 9   [user]" in out.out
    rc = config_tool.cmd_interactive(type("A", (), {"config_dir": None})(),
                                     stdin=io.StringIO("get BAR_WIDTH\nquit\n"))
    assert rc == 0 and "no module selected" in capsys.readouterr().err


def test_config_tool_interactive_entry_via_main(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO("quit\n"))
    rc = config_tool.main(["--config-dir", str(tmp_path), "interactive"])
    assert rc == 0
    assert "interactive config" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_profiling_utils(tmp_path):
    """``trace`` writes the spans recorded in its session into its Chrome
    trace on the trace's own clock: a torch op run inside a span lies
    within it; the profiler itself holds no event of the span's."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        ts = profiling.begin()
        time.sleep(0.001)
        _ = torch.ones(64, 64) @ torch.ones(64, 64)
        time.sleep(0.001)
        profiling.end("glava-span", ts, 7)
    assert not any(e.key == "glava-span" for e in prof.key_averages())
    files = list((tmp_path / "trace").rglob("*.json"))
    assert files, "no trace files written"
    events = json.loads(files[0].read_text())["traceEvents"]
    (span,) = [e for e in events if e.get("name") == "glava-span"]
    assert span["ph"] == "X" and span["args"]["payload"] == 7
    ops = [e for e in events if e.get("name") == "aten::mm"]
    assert ops
    for op in ops:
        assert span["ts"] <= op["ts"]
        assert op["ts"] + op["dur"] <= span["ts"] + span["dur"]
    assert [s.kind for s in profiling.spans()] == ["glava-span"]
    assert not profiling.recording()


def test_nan_guard_checks_each_frame():
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    r = Renderer(loader.load(cli_requests=("setgeometry 0 0 32 24",
                                           "setprintframes false",
                                           'setopacity "xroot"')),
                 device="cpu")
    snap = np.zeros((2, r.cfg.bufsize), np.float32)
    # a live wallpaper with one NaN texel reaches the composited planes
    bg = {"__bg__": torch.ones(4, 24, 32)}
    bg["__bg__"][1, 3, 4] = float("nan")
    profiling.enable_nan_guard()
    try:
        r.step_u8(r.init_state(), snap, True, 0.0, 1.0, 0.05)
        with pytest.raises(FloatingPointError, match="NaN"):
            r.step_u8(r.init_state(), snap, True, 0.0, 1.0, 0.05, bg)
    finally:
        profiling.enable_nan_guard(False)
    r.step_u8(r.init_state(), snap, True, 0.0, 1.0, 0.05, bg)  # off: no check
    assert not profiling.nan_guard_enabled()


# ---------------------------------------------------------------------------
# log-mel frontend
# ---------------------------------------------------------------------------

def _close(got, want, tol=2e-5):
    """Within ``tol`` relative to the peak (tests/test_mel.py)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_rfft_via_packed_matches_jax(n):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, n)).astype(np.float32)
    re, im = mel.rfft_via_packed(torch.as_tensor(x))
    jre, jim = jmel.rfft_via_packed(jnp.asarray(x))
    assert re.shape == (3, n // 2 + 1) and re.dtype == torch.float32
    _close(re.numpy(), jre)
    _close(im.numpy(), jim)
    want = np.fft.rfft(x.astype(np.float64))
    _close(re.numpy(), want.real)


def test_mel_filterbank_is_the_jax_one():
    for args in ((512, 80, 16000), (1024, 64, 22050)):
        assert np.array_equal(mel.mel_filterbank(*args), jmel.mel_filterbank(*args))


@pytest.mark.parametrize("normalize", [True, False])
def test_log_mel_matches_jax(normalize):
    """A second of a tone in noise, framed as Whisper frames it."""
    rng = np.random.default_rng(7)
    sr = 16000
    t = np.arange(sr) / sr
    pcm = (0.5 * np.sin(2 * np.pi * 440.0 * t)
           + 0.05 * rng.standard_normal(sr)).astype(np.float32)
    frames = mel.frame_track(pcm, n_fft=512, hop=160)
    assert np.array_equal(frames, jmel.frame_track(pcm, n_fft=512, hop=160))
    got = mel.log_mel(torch.as_tensor(frames), normalize=normalize)
    want = np.asarray(jmel.log_mel(jnp.asarray(frames), normalize=normalize))
    assert got.shape == want.shape == (frames.shape[0], 80)
    assert got.device.type == "cpu"
    _close(got.numpy(), want)
    host = mel.log_mel(frames, normalize=normalize, device="cpu")
    assert torch.equal(host, got)


def test_log_mel_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        mel.log_mel(np.zeros((2, 512), np.float32))

"""The port stands alone: no jax, no glava_tpu, an explicit device.

These tests run the port in subprocesses so the test process's own
jax import cannot hide a stray one.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "glava_tpu_torch"


def _modules() -> list[str]:
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _run(code: str, *args: str, timeout: float = 120) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, *args] if not code else
                          [sys.executable, "-c", code],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "glava_tpu_torch.ops.fused" in mods and len(mods) > 20
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'glava_tpu' "
        "or k.startswith('glava_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("module", [
    "glava_tpu_torch.ops.raster", "glava_tpu_torch.parallel",
    "glava_tpu_torch.parallel.batch", "glava_tpu_torch.runtime.fleet",
    "glava_tpu_torch.ops.smooth", "glava_tpu_torch.models.mel",
    "glava_tpu_torch.config_tool", "glava_tpu_torch.utils.profiling",
    "glava_tpu_torch.parallel.mesh", "glava_tpu_torch.bench",
    "glava_tpu_torch.entry_points", "glava_tpu_torch.utils.timing",
])
def test_fleet_modules_import_without_jax(module):
    """The many-stream path and its device mesh, the raster and smooth
    kernels' modules, the log-mel frontend, the config tool, the
    profiling helpers, the benchmark, the entry points and the timers,
    each alone in a fresh process with jax blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"import {module}\n"
        "bad = sorted(k for k in sys.modules if k == 'glava_tpu' "
        "or k.startswith('glava_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("module", [
    "glava_tpu_torch.api", "glava_tpu_torch.native",
    "glava_tpu_torch.runtime.engine", "glava_tpu_torch.runtime.stdin_pipe",
    "glava_tpu_torch.runtime.audio.fifo", "glava_tpu_torch.runtime.audio.pulse",
    "glava_tpu_torch.runtime.audio.pa_simple",
])
def test_host_runtime_modules_import_without_jax(module):
    """The host runtime's modules alone, each in a fresh process with jax
    blocked; the native ring loads from ``build/``, never from
    ``glava_tpu/native/`` (whose own library may be absent)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"import {module}\n"
        "from glava_tpu_torch import native\n"
        "if native.available():\n"
        "    assert native._target().parent.parts[-2:] == "
        "('build', 'glava_tpu_torch'), native._target()\n"
        "bad = sorted(k for k in sys.modules if k == 'glava_tpu' "
        "or k.startswith('glava_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_sources_name_neither_jax_nor_glava_tpu_modules():
    for p in PKG.rglob("*.py"):
        for line in p.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s, f"{p}: {s}"
                assert not s.startswith(("import glava_tpu ", "from glava_tpu ",
                                         "from glava_tpu.", "import glava_tpu.")), \
                    f"{p}: {s}"


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(loader.load(), device="cuda")


def test_cli_runs_on_cpu():
    proc = _run("", "-m", "glava_tpu_torch", "--device", "cpu", "--audio",
                "synth", "--frames", "5", "--sink", "null")
    assert proc.returncode == 0, proc.stderr


def test_cli_pipe_is_not_yet_ported():
    """``--pipe`` is ported: the CLI binds the uniform and reads its
    values from stdin (here, one line turning bars green)."""
    proc = subprocess.run(
        [sys.executable, "-m", "glava_tpu_torch", "--device", "cpu", "-a",
         "synth", "--pipe", "fg:vec4", "--frames", "3", "--sink", "null",
         "-r", "setgeometry 0 0 64 48"],
        cwd=ROOT, input="fg = #00ff00\n", capture_output=True, text=True,
        timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep
             + os.environ.get("PYTHONPATH", "")})
    assert proc.returncode == 0, proc.stderr


def test_engine_counts_updates_on_cpu():
    from glava_tpu_torch.ops import fused
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import LatestFrameSink

    sink = LatestFrameSink()
    eng = Engine(EngineOptions(device="cpu", audio_backend="synth", requests=(
        "setgeometry 0 0 64 48", "setprintframes false")), sink=sink)
    before = fused.launches
    eng.run(max_frames=12)
    assert eng.frames_rendered == 12
    assert fused.launches == before          # the CPU path launches nothing
    frame = sink.latest()
    assert frame.shape == (48, 64, 4) and frame.dtype.name == "uint8"

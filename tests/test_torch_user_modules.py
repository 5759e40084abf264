"""User Python modules and ``-C/--copy-config`` against the JAX package.

The port's ``glava_tpu_torch/examples/vu_meter.py``, loaded from a
config root's ``modules/`` with its knob file, against the JAX
``docs/examples/vu_meter.py`` in the recipe of tests/test_config.py's
``test_user_python_module`` (the same snapshot, 6 steps): frames under
the golden rule (tests/test_golden.py:95), single-stream and in a
fleet. A module file written for the JAX package is refused by name
before it runs. ``glava_tpu_torch.cli.copy_config`` and ``python -m
glava_tpu_torch -C`` against ``glava_tpu.cli.copy_config``, with HOME
set to a temporary directory: the same output, line for line, and the
same files copied.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from glava_tpu import cli as jcli
from glava_tpu.config import loader as jloader
from glava_tpu.parallel.batch import BatchedRenderer as JaxBatched
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu_torch import cli, config_tool
from glava_tpu_torch.config import loader
from glava_tpu_torch.parallel import BatchedRenderer, ShardedRenderer, make_mesh
from glava_tpu_torch.render import modules
from glava_tpu_torch.renderer import Renderer
from glava_tpu_torch.runtime.fleet import FleetEngine, StreamSpec
from tests.test_torch_fleet import _assert_frames, _inputs, golden_fraction

ROOT = Path(__file__).resolve().parent.parent
PORT_VU = ROOT / "glava_tpu_torch" / "examples" / "vu_meter.py"
JAX_VU = ROOT / "docs" / "examples" / "vu_meter.py"
RC = "#request mod vu_meter\n#request setgeometry 0 0 64 48\n"


def _config_root(d: Path, module: Path, rc: str = RC) -> Path:
    """A config root holding ``module`` as modules/vu_meter.py, the rc
    and the knob file of tests/test_config.py:211-244."""
    (d / "modules").mkdir(parents=True)
    shutil.copy(module, d / "modules" / "vu_meter.py")
    (d / "rc.glsl").write_text(rc)
    (d / "vu_meter.glsl").write_text("#define METER_COLOR #ff00ff\n")
    return d


def _loads(tmp_path, rc: str = RC):
    return (loader.load(user_dir=_config_root(tmp_path / "port", PORT_VU, rc)),
            jloader.load(user_dir=_config_root(tmp_path / "jax", JAX_VU, rc)))


def test_vu_meter_matches_the_jax_user_module(tmp_path):
    """The load selects the module with its knob file and captures it
    into its own overrides, the global registry untouched; 6 steps of
    one snapshot render within the golden rule of the JAX module's
    frames."""
    lc, jlc = _loads(tmp_path)
    assert lc.module == "vu_meter" and lc.defines["METER_COLOR"] == "#ff00ff"
    assert list(lc.module_overrides) == ["vu_meter"]
    assert "vu_meter" not in modules.available()
    r, jr = Renderer(lc, device="cpu"), JaxRenderer(jlc)
    state, jstate = r.init_state(), jr.init_state()
    step = jr.jit_step(quantize=True)
    snap = (np.random.default_rng(0).standard_normal((2, lc.cfg.bufsize))
            .astype(np.float32) * 0.3)
    for _ in range(6):
        state, frame = r.step_u8(state, snap, True, 0.0, 1.0, 0.05)
        jstate, want = step(jstate, jnp.asarray(snap), True, np.float32(0.0),
                            np.float32(1.0), np.float32(0.05), {})
    got, want = frame.numpy(), np.asarray(want)
    assert got.shape == want.shape == (48, 64, 4) and got.dtype == np.uint8
    assert golden_fraction(got, want) < 0.002
    drawn = got[got[..., 3] > 0]
    # the knob file's METER_COLOR (#ff00ff) is drawn
    assert drawn.size and ((drawn[:, 0] == 255) & (drawn[:, 1] == 0)).any()


def test_vu_meter_fleet_matches_the_jax_fleet(tmp_path):
    """A fleet of 4 vu_meter streams (the module renders one stream at a
    time) against the JAX fleet on the same inputs under the golden rule;
    on a rows mesh (2 stream shards x 2 bands: the module takes its band)
    byte-equal to the unsharded fleet, and through FleetEngine."""
    rc = RC + "#request setbufsize 1024\n#request setsamplesize 256\n"
    lc, jlc = _loads(tmp_path, rc)
    br, jbr = BatchedRenderer(lc, 4, device="cpu"), JaxBatched(jlc, n_streams=4)
    sr = ShardedRenderer([lc], [0] * 4, make_mesh(["cpu"] * 4, rows=2))
    assert all(sh.renderer.module.banded for sh in sr.shards)
    bs, js, ps = br.init_state(), jbr.init_state(), sr.init_state()
    rng = np.random.default_rng(5)
    for it in range(4):
        inputs = _inputs(rng, it, 4)
        bs, got = br.step(bs, *inputs, quantize=True)
        js, want = jbr.step(js, *(jnp.asarray(a) for a in inputs), {},
                            quantize=True)
        ps, parts = sr.step(ps, *inputs, quantize=True)
        _assert_frames(got, np.asarray(want), f"vu_meter fleet step {it}")
        banded = torch.cat([torch.cat(parts[2 * i:2 * i + 2], dim=1)
                            for i in range(2)])
        assert torch.equal(banded, got)
    eng = FleetEngine(lc, [StreamSpec(f"s{i}", source=f"synth:{200 * (i + 1)},"
                                      f"{300 * (i + 1)}") for i in range(4)],
                      mesh=make_mesh(["cpu"] * 4, rows=2))
    eng.run(max_frames=3)
    assert all(eng.tex(i).shape == (48, 64, 4) for i in range(4))


@pytest.mark.parametrize("line", ["import jax", "import jax.numpy as jnp",
                                  "from glava_tpu.render import base",
                                  "import glava_tpu"])
def test_a_jax_user_module_is_refused_by_name(line, tmp_path):
    """A modules/*.py importing jax or glava_tpu is a JAX program: the
    load refuses it with ValueError naming the file and the import, and
    no file of the directory runs."""
    (tmp_path / "modules").mkdir()
    ran = tmp_path / "ran"
    (tmp_path / "modules" / "aaa_ok.py").write_text(
        f"open({str(ran)!r}, 'w').close()\n")
    bad = tmp_path / "modules" / "jaxy.py"
    bad.write_text(f"{line}\nraise SystemExit('the file ran')\n")
    name = line.split()[1]
    with pytest.raises(ValueError, match=rf"jaxy\.py' imports {name}"):
        loader.load(user_dir=tmp_path)
    assert not ran.exists()


def test_shader_module_shadows_python_module(tmp_path):
    """A user shader directory of the same name shadows a user Python
    module, as the JAX loader registers shader modules after Python
    ones."""
    d = _config_root(tmp_path, PORT_VU)
    shutil.copytree(ROOT / "docs" / "examples" / "rings", d / "vu_meter")
    lc, jlc = loader.load(user_dir=d), jloader.load(user_dir=d)
    assert sorted(lc.module_overrides) == sorted(jlc.module_overrides) \
        == ["vu_meter"]
    assert lc.module_overrides["vu_meter"][1] == \
        jlc.module_overrides["vu_meter"][1]


def _copy(fn, home: Path, verbose: bool, capsys) -> tuple[int, str, list]:
    rc = fn(verbose)
    out = capsys.readouterr().out
    dst = home / ".config" / "glava_tpu"
    files = sorted((p.name, p.read_bytes()) for p in dst.iterdir())
    return rc, out, files


@pytest.mark.parametrize("installed", [False, True])
@pytest.mark.parametrize("verbose", [False, True])
def test_copy_config_matches_jax(verbose, installed, tmp_path, capsys,
                                 monkeypatch):
    """``copy_config`` prints and copies what the JAX CLI's does, in the
    same HOME: "skipping"/"copied" lines only when verbose, then the
    install line; an installed root keeps its (edited) files."""
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    dst = home / ".config" / "glava_tpu"
    results = []
    for fn in (jcli.copy_config, cli.copy_config):
        shutil.rmtree(home, ignore_errors=True)
        if installed:
            dst.mkdir(parents=True)
            (dst / "rc.glsl").write_text("#request mod radial\n")
            (dst / "bars.glsl").write_text("#define BAR_WIDTH 9\n")
        results.append(_copy(fn, home, verbose, capsys))
    assert results[0] == results[1]
    rc, out, files = results[1]
    lines = out.splitlines()
    assert rc == 0 and lines[-1] == f"installed user configuration in {dst}"
    assert any(n == "smooth_parameters.glsl" for n, _ in files)
    assert (dst / "rc.glsl").read_text() == (
        "#request mod radial\n" if installed else
        (loader.SYSTEM_SHADER_DIR / "rc.glsl").read_text())
    assert (len(lines) > 1) == verbose
    assert any(ln.startswith("skipping") for ln in lines) == (
        verbose and installed)


def test_copy_config_flag_and_install_command(tmp_path, capsys, monkeypatch):
    """``python -m glava_tpu_torch -C -v`` prints what ``python -m
    glava_tpu -C -v`` prints in a fresh HOME; the config tool's
    ``install`` is ``copy_config(verbose=True)``."""
    outs = []
    for pkg in ("glava_tpu", "glava_tpu_torch"):
        home = tmp_path / pkg
        env = dict(os.environ, HOME=str(home), JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(ROOT))
        proc = subprocess.run([sys.executable, "-m", pkg, "-C", "-v"],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout.replace(str(home), "HOME"))
    assert outs[0] == outs[1] and "copied '" in outs[1]
    monkeypatch.setenv("HOME", str(tmp_path / "tool"))
    assert config_tool.main(["install"]) == 0
    tool_out = capsys.readouterr().out
    assert tool_out.replace(str(tmp_path / "tool"), "HOME") == outs[1]

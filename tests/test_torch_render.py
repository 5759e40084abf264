"""Frames from the port against the golden archive and the live JAX frame.

The port renders every module of tests/test_golden.py's ``CASES`` with
its ``render_case`` inputs (24 updates of fixed stereo tones) at the
case's size and at the 64x64 tiny geometry (with ``TINY_KNOBS``).
Tolerance: the golden rule — under 0.2% of pixels more than 2 LSB
apart.
"""

from __future__ import annotations

from pathlib import Path

import tempfile

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from glava_tpu.config import loader as jloader
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu_torch import interop
from glava_tpu_torch.config import loader
from glava_tpu_torch.renderer import Renderer
from tests.test_golden import CASES, GOLDEN, TINY_KNOBS, TINY_SCREEN, render_case

BARS = CASES["bars"]
MODULES = sorted(CASES)


def golden_fraction(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    return float((np.abs(got.astype(np.int16) - want.astype(np.int16)) > 2).mean())


def _requests(screen, tiny):
    reqs = (f"setgeometry 0 0 {screen[0]} {screen[1]}", "setprintframes false")
    if tiny:
        reqs += ("setbufsize 256", "setsamplesize 64")
    return reqs


def _snapshots(cfg, count):
    """render_case's ring snapshots of 440 Hz / 3000 Hz tones."""
    t = np.arange(cfg.sample_rate) / cfg.sample_rate
    le = (0.4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    ri = (0.4 * np.sin(2 * np.pi * 3000.0 * t)).astype(np.float32)
    out = []
    for k in range(count):
        end = (k + 1) * cfg.hop
        snap = np.zeros((2, cfg.bufsize), np.float32)
        for ch, b in enumerate((le, ri)):
            seg = b[max(end - cfg.bufsize, 0):end]
            snap[ch, cfg.bufsize - len(seg):] = seg
        out.append(snap)
    return out


def _load_tiny(module, screen, tiny, load=loader.load):
    """``load`` of ``module`` at ``screen``, with the module's
    ``TINY_KNOBS`` file at the tiny geometry (as ``render_case``)."""
    reqs = _requests(screen, tiny)
    if not (tiny and module in TINY_KNOBS):
        return load(cli_requests=reqs, force_module=module)
    with tempfile.TemporaryDirectory() as td:
        (Path(td) / f"{module}.glsl").write_text(TINY_KNOBS[module])
        return load(cli_requests=reqs, force_module=module, user_dir=td)


def port_render(screen, tiny=False, module="bars") -> np.ndarray:
    lc = _load_tiny(module, screen, tiny)
    r = Renderer(lc, device="cpu")
    cfg = lc.cfg
    g = float(np.float32(cfg.gravity_step / cfg.nominal_ups))
    state = r.init_state()
    for snap in _snapshots(cfg, 24):
        state, frame = r.step_u8(state, snap, True, 0.25, 1.0, g)
    return frame.numpy()


@pytest.mark.parametrize("tiny", [False, True], ids=["cases", "64x64"])
@pytest.mark.parametrize("module", MODULES)
def test_module_meets_golden_archive(module, tiny):
    want = np.load(GOLDEN)[f"{module}_tiny" if tiny else module]
    got = port_render(TINY_SCREEN if tiny else CASES[module], tiny, module)
    assert (got[..., 3] > 0).any(), f"{module} drew nothing"
    assert golden_fraction(got, want) < 0.002


@pytest.mark.parametrize("tiny", [False, True], ids=["cases", "64x64"])
@pytest.mark.parametrize("module", MODULES)
def test_module_meets_live_jax_frame(module, tiny):
    screen = TINY_SCREEN if tiny else CASES[module]
    want = render_case(module, screen, tiny=tiny)
    assert golden_fraction(port_render(screen, tiny, module), want) < 0.002


def _jax_steps(screen, count, module="bars"):
    lc = _load_tiny(module, screen, False, jloader.load)
    r = JaxRenderer(lc)
    cfg = lc.cfg
    g = np.float32(cfg.gravity_step / cfg.nominal_ups)
    step = r.jit_step(quantize=True)
    state = r.init_state()
    snaps = _snapshots(cfg, count + 1)
    for snap in snaps[:count]:
        state, _ = step(state, jnp.asarray(snap), True, np.float32(0.25),
                        np.float32(1.0), g, {})
    return state, step, snaps[count], g


CARRY = {"bars": (BARS, 10), "wave": (CASES["wave"], 5),
         "circle": (CASES["circle"], 5)}


@pytest.mark.parametrize("modified", [True, False])
@pytest.mark.parametrize("module", sorted(CARRY))
def test_state_carries_over_from_jax(module, modified):
    """A few JAX steps, then one more step in each package from the
    same state: the frames meet the golden rule. With
    ``modified=False`` an fft module's frame comes from the carried
    average, which interop recomputes; wave's state holds no chains
    (its one uniform has no fft) and its frame reads the carried
    keyframe."""
    screen, steps = CARRY[module]
    jstate, step, snap, g = _jax_steps(screen, steps, module)
    leaves = jax.tree.map(np.asarray, jstate)
    lc = _load_tiny(module, screen, False)
    r = Renderer(lc, device="cpu")
    pstate = interop.state_from_jax_numpy(leaves, lc.cfg, "cpu")
    _, want = step(jstate, jnp.asarray(snap), modified, np.float32(0.25),
                   np.float32(1.0), g, {})
    _, got = r.step_u8(pstate, snap, modified, 0.25, 1.0, float(g))
    assert (got[..., 3] > 0).any()
    assert golden_fraction(got.numpy(), np.asarray(want)) < 0.002


@pytest.mark.parametrize("bufsize", [131072, 262144])
def test_split_bufsizes_meet_live_jax_frame(bufsize, tmp_path):
    """Accel-path bufsizes above the one-cluster kernel's 65536, smooth
    pass off (its dense matrix would take tens of GB in both packages;
    a user ``smooth_parameters.glsl`` turns it off, since the shipped
    one, read after the command line's requests, turns it on): the
    port's Renderer takes the kernel route (its plain version on the
    CPU) and its bars frame after a few updates meets the JAX
    Renderer's under the golden rule."""
    (tmp_path / "smooth_parameters.glsl").write_text(
        "#request setsmoothpass false\n")
    reqs = _requests(BARS, False) + (f"setbufsize {bufsize}",)
    lc, jlc = (load(cli_requests=reqs, force_module="bars",
                    user_dir=str(tmp_path))
               for load in (loader.load, jloader.load))
    assert not lc.cfg.smooth_pass and not jlc.cfg.smooth_pass
    r, jr = Renderer(lc, device="cpu"), JaxRenderer(jlc)
    assert r.pipeline.route == "kernel" and r.pipeline.sz == bufsize
    cfg = lc.cfg
    g = np.float32(cfg.gravity_step / cfg.nominal_ups)
    step = jr.jit_step(quantize=True)
    state, jstate = r.init_state(), jr.init_state()
    for snap in _snapshots(cfg, 3):
        state, got = r.step_u8(state, snap, True, 0.25, 1.0, float(g))
        jstate, want = step(jstate, jnp.asarray(snap), True, np.float32(0.25),
                            np.float32(1.0), g, {})
    assert (got[..., 3] > 0).any()
    assert golden_fraction(got.numpy(), np.asarray(want)) < 0.002


@pytest.mark.parametrize("module", ["bars", "wave"])
def test_state_round_trips_through_numpy(module):
    lc = loader.load(cli_requests=_requests(TINY_SCREEN, True), force_module=module)
    r = Renderer(lc, device="cpu")
    state = r.init_state()
    for snap in _snapshots(lc.cfg, 4):
        state, _ = r.step_u8(state, snap, True, 0.25, 1.0, 0.05)
    leaves = interop.state_to_numpy(state)
    assert bool(leaves["chains"]) == (module != "wave")
    back = interop.state_from_jax_numpy(leaves, lc.cfg, "cpu")
    for a, b in zip(back.chains, state.chains):
        assert torch.equal(a, b)
    assert torch.equal(back.key_start, state.key_start)
    assert torch.equal(back.key_end, state.key_end)


def test_ring_state_average_matches_port_average():
    """The average interop recomputes from a JAX ring history equals
    the one the port carries after the same updates."""
    jstate, _, _, _ = _jax_steps(TINY_SCREEN, 7)
    lc = loader.load(cli_requests=_requests(TINY_SCREEN, False), force_module="bars")
    r = Renderer(lc, device="cpu")
    cfg = lc.cfg
    g = float(np.float32(cfg.gravity_step / cfg.nominal_ups))
    state = r.init_state()
    for snap in _snapshots(cfg, 7):
        state, _ = r.step_u8(state, snap, True, 0.25, 1.0, g)
    carried = interop.state_from_jax_numpy(jax.tree.map(np.asarray, jstate),
                                           cfg, "cpu")
    np.testing.assert_allclose(carried.chains.avg.numpy(),
                               state.chains.avg.numpy(), atol=2e-5)
    assert torch.equal(carried.chains.count, state.chains.count)


def test_frame_layout_and_float_step():
    lc = loader.load(cli_requests=_requests((48, 32), False), force_module="bars")
    r = Renderer(lc, device="cpu")
    state = r.init_state()
    snap = _snapshots(lc.cfg, 3)[-1]
    _, f32 = r.step(state, snap, True, 0.0, 1.0, 0.05)
    _, u8 = r.step_u8(r.init_state(), snap, True, 0.0, 1.0, 0.05)
    assert f32.shape == (32, 48, 4) and f32.dtype == torch.float32
    assert u8.shape == (32, 48, 4) and u8.dtype == torch.uint8
    assert torch.equal(torch.clamp(torch.round(f32 * 255.0), 0, 255).to(torch.uint8), u8)


VARIANTS = {
    "bars-no_smooth_pass": (("setsmoothpass false",), ""),
    "bars-xroot_composite": (("setopacity \"xroot\"", "setbg 203040ff"), ""),
    "bars-alpha_premultiply": ((), "#define USE_ALPHA 1\n"),
    "bars-invert_flip": ((), "#define INVERT 1\n#define FLIP 1\n"),
    "bars-mirror_yx_direction": ((), "#define MIRROR_YX 1\n#define DIRECTION 1\n"),
    "bars-mono": (("setmirror true",), ""),
    "bars-no_outline": ((), "#define BAR_OUTLINE_WIDTH 0\n#define BAR_WIDTH 3\n"),
    "radial-bar_outline": ((), "#define BAR_OUTLINE_WIDTH 1\n"),
    "radial-invert": ((), "#define INVERT 1\n"),
    "radial-center_offset_x": ((), "#define CENTER_OFFSET_X 9\n"),
    "circle-fill": ((), "#define C_FILL 1\n"),
    "circle-no_smooth": ((), "#define C_SMOOTH 0\n"),
    "circle-no_smooth_pass": (("setsmoothpass false",), ""),
    "graph-anti_alias": ((), "#define ANTI_ALIAS 1\n"),
    "graph-anti_alias_silence": ((), "#define ANTI_ALIAS 1\n"),
    "graph-join_channels": ((), "#define JOIN_CHANNELS 1\n"),
    "graph-invert": ((), "#define INVERT 1\n"),
    "graph-draw_outline": ((), "#define DRAW_OUTLINE 1\n"),
    "graph-direction_reversed": ((), "#define DIRECTION -1\n"),
    "wave-silence": ((), ""),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variants_meet_live_jax_frame(variant, tmp_path):
    """Knob and request variants through both packages, 6 updates of
    render_case's tones (or of silence) at 96x64 and bufsize 1024;
    radial and circle with their TINY_KNOBS radius. Golden rule."""
    module, name = variant.split("-", 1)
    reqs, knobs = VARIANTS[variant]
    reqs = _requests((96, 64), False) + ("setbufsize 1024",
                                         "setsamplesize 256") + tuple(reqs)
    (tmp_path / f"{module}.glsl").write_text(TINY_KNOBS.get(module, "") + knobs)
    kw = dict(cli_requests=reqs, force_module=module, user_dir=tmp_path)
    jr = JaxRenderer(jloader.load(**kw))
    r = Renderer(loader.load(**kw), device="cpu")
    cfg = r.cfg
    g = np.float32(cfg.gravity_step / cfg.nominal_ups)
    jstep = jr.jit_step(quantize=True)
    js, ps = jr.init_state(), r.init_state()
    silence = name.endswith("silence")
    for snap in _snapshots(cfg, 6):
        if silence:
            snap = np.zeros_like(snap)
        js, want = jstep(js, jnp.asarray(snap), True, np.float32(0.25),
                         np.float32(1.0), g, {})
        ps, got = r.step_u8(ps, snap, True, 0.25, 1.0, float(g))
    if not silence:
        assert (got[..., 3] > 0).any()
    assert golden_fraction(got.numpy(), np.asarray(want)) < 0.002


def test_unported_module_raises(tmp_path):
    """A user Python module written for the JAX package
    (``<user_dir>/modules/*.py`` importing ``glava_tpu``) is refused by
    name before it runs; one written for the port loads
    (tests/test_torch_user_modules.py), and so do user GLSL shader
    modules (tests/test_torch_interp.py)."""
    (tmp_path / "modules").mkdir()
    (tmp_path / "modules" / "mine.py").write_text(
        "from glava_tpu.render.modules import register\nMODULE = None\n")
    with pytest.raises(ValueError, match=r"mine\.py' imports "
                       r"glava_tpu\.render\.modules"):
        loader.load(cli_requests=_requests((48, 32), False),
                    force_module="mine", user_dir=tmp_path)


LAUNCHES_PER_FRAME = {"bars": 0, "radial": 1, "circle": 1, "wave": 0,
                      "graph": 0, "test": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("module", sorted(LAUNCHES_PER_FRAME))
def test_cuda_frame_meets_cpu_frame(module):
    """On the card the module renders through the kernels: the frame
    meets the golden rule against the CPU frame, and the lookup kernel
    launched once a frame where the module has a static lookup."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from glava_tpu_torch.ops import lookup

    screen = CASES.get(module, (64, 64))
    frames = {}
    for dev in ("cpu", "cuda"):
        r = Renderer(_load_tiny(module, screen, False), device=dev)
        g = float(np.float32(r.cfg.gravity_step / r.cfg.nominal_ups))
        state = r.init_state()
        before = lookup.launches
        for snap in _snapshots(r.cfg, 24):
            state, frame = r.step_u8(state, snap, True, 0.25, 1.0, g)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert lookup.launches - before == 24 * LAUNCHES_PER_FRAME[module]
        frames[dev] = frame.cpu().numpy()
    assert golden_fraction(frames["cuda"], frames["cpu"]) < 0.002


def test_golden_archive_is_present():
    assert Path(GOLDEN).is_file()

"""Frames from the port against the golden archive and the live JAX frame.

The port renders ``bars`` with tests/test_golden.py's ``render_case``
inputs (24 updates of fixed stereo tones) at (192, 128) and at the
64x64 tiny geometry. Tolerance: the golden rule — under 0.2% of pixels
more than 2 LSB apart.
"""

from __future__ import annotations

from pathlib import Path

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
from tests.test_golden import CASES, GOLDEN, TINY_SCREEN, render_case

BARS = CASES["bars"]


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


def port_render(screen, tiny=False) -> np.ndarray:
    lc = loader.load(cli_requests=_requests(screen, tiny), force_module="bars")
    r = Renderer(lc, device="cpu")
    cfg = lc.cfg
    g = float(np.float32(cfg.gravity_step / cfg.nominal_ups))
    state = r.init_state()
    for snap in _snapshots(cfg, 24):
        state, frame = r.step_u8(state, snap, True, 0.25, 1.0, g)
    return frame.numpy()


@pytest.mark.parametrize("tiny", [False, True], ids=["192x128", "64x64"])
def test_bars_meets_golden_archive(tiny):
    want = np.load(GOLDEN)["bars_tiny" if tiny else "bars"]
    got = port_render(TINY_SCREEN if tiny else BARS, tiny)
    assert (got[..., 3] > 0).any(), "bars drew nothing"
    assert golden_fraction(got, want) < 0.002


@pytest.mark.parametrize("tiny", [False, True], ids=["192x128", "64x64"])
def test_bars_meets_live_jax_frame(tiny):
    screen = TINY_SCREEN if tiny else BARS
    want = render_case("bars", screen, tiny=tiny)
    assert golden_fraction(port_render(screen, tiny), want) < 0.002


def _jax_steps(screen, count):
    lc = jloader.load(cli_requests=_requests(screen, False), force_module="bars")
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


@pytest.mark.parametrize("modified", [True, False])
def test_state_carries_over_from_jax(modified):
    """10 JAX steps, then one more step in each package from the same
    state: the frames meet the golden rule. With ``modified=False`` the
    frame comes from the carried average, which interop recomputes."""
    jstate, step, snap, g = _jax_steps(BARS, 10)
    leaves = jax.tree.map(np.asarray, jstate)
    lc = loader.load(cli_requests=_requests(BARS, False), force_module="bars")
    r = Renderer(lc, device="cpu")
    pstate = interop.state_from_jax_numpy(leaves, lc.cfg, "cpu")
    _, want = step(jstate, jnp.asarray(snap), modified, np.float32(0.25),
                   np.float32(1.0), g, {})
    _, got = r.step_u8(pstate, snap, modified, 0.25, 1.0, float(g))
    assert (got[..., 3] > 0).any()
    assert golden_fraction(got.numpy(), np.asarray(want)) < 0.002


def test_state_round_trips_through_numpy():
    lc = loader.load(cli_requests=_requests(TINY_SCREEN, True), force_module="bars")
    r = Renderer(lc, device="cpu")
    state = r.init_state()
    for snap in _snapshots(lc.cfg, 4):
        state, _ = r.step_u8(state, snap, True, 0.25, 1.0, 0.05)
    back = interop.state_from_jax_numpy(interop.state_to_numpy(state), lc.cfg, "cpu")
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
    "no_smooth_pass": (("setsmoothpass false",), ""),
    "xroot_composite": (("setopacity \"xroot\"", "setbg 203040ff"), ""),
    "alpha_premultiply": ((), "#define USE_ALPHA 1\n"),
    "invert_flip": ((), "#define INVERT 1\n#define FLIP 1\n"),
    "mirror_yx_direction": ((), "#define MIRROR_YX 1\n#define DIRECTION 1\n"),
    "mono": (("setmirror true",), ""),
    "no_outline": ((), "#define BAR_OUTLINE_WIDTH 0\n#define BAR_WIDTH 3\n"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bars_variants_meet_live_jax_frame(variant, tmp_path):
    """Knob and request variants of bars through both packages, 6
    updates of render_case's tones at bufsize 1024; golden rule."""
    reqs, knobs = VARIANTS[variant]
    reqs = _requests((96, 64), False) + ("setbufsize 1024",
                                         "setsamplesize 256") + tuple(reqs)
    (tmp_path / "bars.glsl").write_text(knobs)
    kw = dict(cli_requests=reqs, force_module="bars", user_dir=tmp_path)
    jr = JaxRenderer(jloader.load(**kw))
    r = Renderer(loader.load(**kw), device="cpu")
    cfg = r.cfg
    g = np.float32(cfg.gravity_step / cfg.nominal_ups)
    jstep = jr.jit_step(quantize=True)
    js, ps = jr.init_state(), r.init_state()
    for snap in _snapshots(cfg, 6):
        js, want = jstep(js, jnp.asarray(snap), True, np.float32(0.25),
                         np.float32(1.0), g, {})
        ps, got = r.step_u8(ps, snap, True, 0.25, 1.0, float(g))
    assert (got[..., 3] > 0).any()
    assert golden_fraction(got.numpy(), np.asarray(want)) < 0.002


def test_unported_module_raises():
    lc = loader.load(cli_requests=_requests((48, 32), False), force_module="radial")
    with pytest.raises(NotImplementedError, match="slice 2"):
        Renderer(lc, device="cpu")


def test_golden_archive_is_present():
    assert Path(GOLDEN).is_file()

"""The compiled step with live pipe values, and the compiled step of GLSL
shader modules (``glava_tpu_torch.compiled``, ``ops.graph_while``),
against the port's eager step and the JAX package's jitted step.

On the CPU a compiled step runs its static-buffer body eagerly, and a
data-dependent GLSL loop runs the while node's plain version (the
condition read where the CPU tensors live): the code a card captures.

* **pipe values are step inputs**: bars, radial and graph on one
  stream, and the S = 4 batched, mixed and sharded fleets, take a
  different pipe value every frame; the frames are byte-equal to the
  eager step's, and each step captures once a branch
  (``Step.captures``), as JAX traces once;
* **shader modules**: rings, the anti-alias walk, the run-time-row
  fetch, the smooth transform and an audio-driven loop
  (``chip_smoke.SHADER_MODULES``) through ``jit_step``, a pipe write
  every frame: byte-equal to the eager ``step_u8`` and within the golden
  rule (under 0.2% of pixels more than 2 LSB off) of ``glava_tpu``'s
  ``jit_step``; the audio loop's trip count changes from frame to frame;
* the sync guard of ``tests/test_torch_compiled.py`` on each of them and
  on the interpreter's loop cases (``while_masked``,
  ``return_nested_while``, ``valued_return_in_helper``);
* the fuel counter: a loop truncated at a small ``GLAVA_TPU_WHILE_FUEL``
  counts the same pixels in the compiled step as in the eager one, and
  raises at the read under ``GLAVA_TPU_WHILE_FUEL_STRICT=1``.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from glava_tpu.config import loader as jloader
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu_torch import compiled
from glava_tpu_torch.config import glsl_shader, loader
from glava_tpu_torch.render.base import ModuleContext
from glava_tpu_torch.ops import graph_while
from glava_tpu_torch.parallel import (
    BatchedRenderer, MixedBatchedRenderer, ShardedRenderer, make_mesh,
)
from glava_tpu_torch.renderer import CompiledStep, Renderer
from glava_tpu_torch.runtime import sinks
from glava_tpu_torch.runtime.engine import Engine, EngineOptions
from tests.test_torch_compiled import (
    _fleet_inputs, _loads, _no_host_data, _no_host_reads, golden_fraction,
)
from tests.test_torch_interp import INLINE, _write

S = 4
REQS = ("setgeometry 0 0 96 64", "setprintframes false", "setbufsize 1024",
        "setsamplesize 256")
SHADERS = tuple(chip_smoke.SHADER_MODULES)
LOOPS = ("while_masked", "return_nested_while", "valued_return_in_helper")


def _fg(k: int, n: int | None = None) -> np.ndarray:
    """A pipe value that differs every frame (and every stream)."""
    base = np.float32([0.1 + 0.13 * k, 0.9 - 0.1 * k, 0.3, 1.0]) % 1.0
    if n is None:
        return base
    return np.stack([np.roll(base, s) for s in range(n)]).astype(np.float32)


def _snaps(n: int, seed: int = 4) -> list[np.ndarray]:
    """Audio that changes its loudness frame to frame (silence, then
    louder): a data-dependent loop takes another trip count each frame."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 1024)) * 0.15 * (k % 3)
             ).astype(np.float32) for k in range(n)]


def _shader_loads(module, tmp_path):
    root = chip_smoke.write_shader_modules(tmp_path / "shaders")
    kw = dict(cli_requests=REQS, force_module=module, user_dir=root)
    return loader.load(**kw), jloader.load(**kw)


# -- pipe values: one graph for every value ----------------------------------

@pytest.mark.parametrize("module", ["bars", "radial", "graph"])
def test_pipe_write_every_frame_keeps_one_capture(module, tmp_path):
    lc, _ = _loads(module, tmp_path)
    r = Renderer(lc, device="cpu")
    step = r.jit_step(quantize=True)
    cs, es = r.init_state(), r.init_state()
    for k, snap in enumerate(_snaps(6)):
        pipe = {"fg": _fg(k), "bg": _fg(k + 3)}
        mod = k != 3
        cs, got = step(cs, snap, mod, 0.1 * k, 1.0, 0.05, pipe)
        es, want = r.step_u8(es, snap, mod, 0.1 * k, 1.0, 0.05, pipe)
        assert np.array_equal(got.numpy(), want.numpy()), f"frame {k}"
    # two branches (modified and not), whatever the pipe values
    assert step.step.captures == 2
    # a new pipe name is a new input layout: one capture more
    step(cs, snap, True, 0.0, 1.0, 0.05, {"fg": _fg(0)})
    assert step.step.captures == 3


@pytest.mark.parametrize("module", ["bars", "radial", "graph"])
def test_knobs_run_only_for_the_pipe_names_they_read(module, tmp_path,
                                                     monkeypatch):
    """A pipe name no knob reads costs no knob evaluation after the
    first frame, and leaves the frame as it is with no pipe value; a
    name a knob reads evaluates every frame."""
    lc, _ = _loads(module, tmp_path)
    r = Renderer(lc, device="cpu")
    calls = []
    real = ModuleContext.eval_color
    monkeypatch.setattr(ModuleContext, "eval_color",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    step = r.jit_step(quantize=True)
    cs, es = r.init_state(), r.init_state()
    for k, snap in enumerate(_snaps(4)):
        cs, got = step(cs, snap, True, 0.1 * k, 1.0, 0.05,
                       {"nobody": _fg(k)})
        es, want = r.step_u8(es, snap, True, 0.1 * k, 1.0, 0.05)
        assert np.array_equal(got.numpy(), want.numpy()), f"frame {k}"
        if k == 0:
            calls.clear()
    assert calls == []
    for k, snap in enumerate(_snaps(3)):
        step(cs, snap, True, 0.1 * k, 1.0, 0.05, {"fg": _fg(k)})
    assert calls.count("COLOR") == 3


def _fleet(kind, tmp_path):
    if kind == "mixed":
        loads = [_loads(m, tmp_path)[0] for m in ("bars", "radial", "graph")]
        return MixedBatchedRenderer(loads, [0, 1, 2, 1], device="cpu")
    lc, _ = _loads("bars", tmp_path)
    if kind == "sharded":
        return ShardedRenderer([lc], [0] * S, make_mesh(["cpu"] * 2))
    return BatchedRenderer(lc, S, device="cpu")


@pytest.mark.parametrize("kind", ["batched", "mixed", "sharded"])
def test_fleet_pipe_write_every_frame_keeps_one_capture(kind, tmp_path):
    br = _fleet(kind, tmp_path)
    step = br.jit_step(quantize=True)
    cs, es = br.init_state(), br.init_state()
    rng = np.random.default_rng(3)
    for it in range(6):
        inputs = _fleet_inputs(rng, it)
        pipe = {"fg": _fg(it, S)}
        cs, got = step(cs, *inputs, pipe)
        es, want = br.step(es, *inputs, pipe, quantize=True)
        if kind == "sharded":
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), w.numpy()), f"step {it}"
        else:
            assert np.array_equal(got.numpy(), want.numpy()), f"step {it}"
    steps = step.steps if kind == "sharded" else [step]
    assert [s.step.captures for s in steps] == [1] * len(steps)


# -- shader modules: the compiled step ---------------------------------------

@pytest.mark.parametrize("module", SHADERS)
def test_shader_jit_step_meets_jax_and_the_eager_step(module, tmp_path,
                                                      monkeypatch):
    lc, jlc = _shader_loads(module, tmp_path)
    r, jr = Renderer(lc, device="cpu"), JaxRenderer(jlc)
    step, jstep = r.jit_step(quantize=True), jr.jit_step(quantize=True)
    assert r.module.kind == "shader"
    checks = []
    plain = graph_while.condition_plain
    monkeypatch.setattr(graph_while, "condition_plain",
                        lambda *a: checks.append(1) or plain(*a))
    trips = []
    cs, es, js = r.init_state(), r.init_state(), jr.init_state()
    for k, snap in enumerate(_snaps(6)):
        pipe = {"fg": _fg(k)}
        mod, t = k != 4, 0.3 * k
        n0 = len(checks)
        cs, got = step(cs, snap, mod, t, 1.0, 0.05, pipe)
        got = got.numpy().copy()
        trips.append(len(checks) - n0)
        es, want_e = r.step_u8(es, snap, mod, t, 1.0, 0.05, pipe)
        js, want_j = jstep(js, jnp.asarray(snap), mod, np.float32(t),
                           np.float32(1.0), np.float32(0.05),
                           {n: jnp.asarray(v) for n, v in pipe.items()})
        assert np.array_equal(got, want_e.numpy()), f"frame {k}"
        frac = golden_fraction(got, np.asarray(want_j))
        assert frac < 0.002, f"frame {k}: {frac:.4%} off"
    assert (got[..., 3] > 0).any() or module == "audioloop"
    if module == "audioloop":
        # the general masked loop, its trip count set by the audio
        assert len(set(trips)) > 2, trips
    assert step.step.captures == 2


@pytest.mark.parametrize("case", SHADERS + LOOPS)
def test_static_shader_step_reads_nothing_on_the_host(case, tmp_path):
    if case in INLINE:
        lc = loader.load(user_dir=_write(tmp_path, case, (INLINE[case],),
                                         (96, 64)))
    else:
        lc, _ = _shader_loads(case, tmp_path)
    r = Renderer(lc, device="cpu")
    step = r.jit_step(quantize=True)
    st = r.init_state()
    snaps = _snaps(5, seed=1)
    for mod in (True, False):          # warm up both branches
        st, _ = step(st, snaps[0], mod, 0.1, 0.5, 0.05, {"fg": _fg(0)})
    step._body = _no_host_data(step._body)
    with _no_host_reads():
        for k, snap in enumerate(snaps[1:]):
            st, frame = step(st, snap, k != 1, 0.2 * k, 0.5, 0.05,
                             {"fg": _fg(k + 1)})
    assert frame.shape == (64, 96, 4)


def test_shader_fleet_steps_take_each_streams_pipe_row(tmp_path):
    """An S = 4 fleet of the audio loop (renders one stream at a time
    inside the step): each stream's pipe row and time, a write every
    frame, byte-equal to the eager fleet, one capture."""
    lc, _ = _shader_loads("audioloop", tmp_path)
    br = BatchedRenderer(lc, S, device="cpu")
    step = br.jit_step(quantize=True)
    cs, es = br.init_state(), br.init_state()
    rng = np.random.default_rng(6)
    for it in range(4):
        audio, mods, _, interp, g = _fleet_inputs(rng, it)
        t = np.float32([0.1 * it + s for s in range(S)])
        pipe = {"fg": _fg(it, S)}
        cs, got = step(cs, audio, mods, t, interp, g, pipe)
        es, want = br.step(es, audio, mods, t, interp, g, pipe,
                           quantize=True)
        assert np.array_equal(got.numpy(), want.numpy()), f"step {it}"
    assert step.step.captures == 1


# -- the fuel counter ---------------------------------------------------------

def test_fuel_counter_counts_what_the_eager_step_reports(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("GLAVA_TPU_WHILE_FUEL", "4")
    monkeypatch.delenv("GLAVA_TPU_WHILE_FUEL_STRICT", raising=False)
    monkeypatch.delenv("GLAVA_TPU_WHILE_FUEL_WARN", raising=False)
    reports = []
    monkeypatch.setattr(glsl_shader, "_fuel_report",
                        lambda n, cap: reports.append((n, cap)))
    lc = loader.load(user_dir=_write(tmp_path, "while_masked",
                                     (INLINE["while_masked"],), (96, 64)))
    r = Renderer(lc, device="cpu")
    step = r.jit_step(quantize=True)
    snap = _snaps(1)[0]
    _, want = r.step_u8(r.init_state(), snap, True, 0.0, 1.0, 0.05)
    eager = sum(n for n, _ in reports)
    reports.clear()
    _, got = step(r.init_state(), snap, True, 0.0, 1.0, 0.05)
    assert reports == []                 # the step itself reads nothing
    assert glsl_shader.fuel_check(force=True) == eager
    assert reports == [(eager, 4)]
    assert torch_equal(got, want)
    # pixels at x > 4 still count when the fuel runs out at 4
    assert eager == 64 * 92
    monkeypatch.setenv("GLAVA_TPU_WHILE_FUEL_STRICT", "1")
    monkeypatch.setattr(glsl_shader, "_fuel_report", _STRICT_REPORT)
    step(r.init_state(), snap, True, 0.0, 1.0, 0.05)
    with pytest.raises(RuntimeError, match="fuel cap"):
        glsl_shader.fuel_check(force=True)
    with pytest.raises(RuntimeError, match="fuel cap"):
        r.step_u8(r.init_state(), snap, True, 0.0, 1.0, 0.05)


_STRICT_REPORT = glsl_shader._fuel_report


def torch_equal(a, b) -> bool:
    return np.array_equal(a.numpy(), b.numpy())


def test_engine_reads_the_fuel_counter(tmp_path, monkeypatch):
    """The Engine's compiled step counts the truncated pixels on the
    device; the Engine reports them at the end of the run, and raises
    there under GLAVA_TPU_WHILE_FUEL_STRICT=1."""
    monkeypatch.setenv("GLAVA_TPU_WHILE_FUEL", "4")
    monkeypatch.delenv("GLAVA_TPU_WHILE_FUEL_STRICT", raising=False)
    monkeypatch.delenv("GLAVA_TPU_WHILE_FUEL_WARN", raising=False)
    reports = []
    monkeypatch.setattr(glsl_shader, "_fuel_report",
                        lambda n, cap: reports.append((n, cap)))
    root = _write(tmp_path, "while_masked", (INLINE["while_masked"],),
                  (96, 64))

    def engine():
        return Engine(EngineOptions(audio_backend="synth", screen=(96, 64),
                                    device="cpu", user_dir=str(root),
                                    requests=("setprintframes false",)),
                      sink=sinks.NullSink())

    eng = engine()
    assert isinstance(eng._step, CompiledStep)
    eng.run(max_frames=3)
    assert sum(n for n, _ in reports) == 3 * 64 * 92
    assert {cap for _, cap in reports} == {4}
    monkeypatch.setenv("GLAVA_TPU_WHILE_FUEL_STRICT", "1")
    monkeypatch.setattr(glsl_shader, "_fuel_report", _STRICT_REPORT)
    with pytest.raises(RuntimeError, match="fuel cap"):
        engine().run(max_frames=2)


def test_fuel_counter_keys_a_card_by_its_index(monkeypatch):
    """The counter of a card's planes (``cuda:0``) is the one a caller
    holding ``cuda`` (the current card) reads."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert glsl_shader._fuel_device("cuda") == torch.device("cuda", 0)
    assert glsl_shader._fuel_device("cuda:1") == torch.device("cuda", 1)
    assert glsl_shader._fuel_device("cpu") == torch.device("cpu")
    reports = []
    monkeypatch.setattr(glsl_shader, "_fuel_report",
                        lambda n, cap: reports.append((n, cap)))
    # CPU tensors stand for the counters the cards' planes keep
    monkeypatch.setattr(glsl_shader, "_FUEL", {
        torch.device("cuda", 0): [torch.tensor(5), 7],
        torch.device("cuda", 1): [torch.tensor(11), 7]})
    assert glsl_shader.fuel_check("cuda", force=True) == 5
    assert glsl_shader.fuel_check(torch.device("cuda", 1), force=True) == 11
    assert reports == [(5, 7), (11, 7)]


# -- a capture's refusal ------------------------------------------------------

def test_a_capture_refusal_raises_naming_the_module(tmp_path):
    """A host value a capture meets first (not made in the warm-up)
    raises out of the step's call, naming the module: no path falls
    back to the eager step."""
    lc, _ = _shader_loads("rings", tmp_path)
    r = Renderer(lc, device="cpu")
    step = r.jit_step(quantize=True)
    assert isinstance(step, CompiledStep)
    s = step.step
    host = np.arange(3, dtype=np.float32)
    with compiled._body_of(s, "warm"):
        made = compiled.const(host)
    with compiled._body_of(s, "capture"):
        assert compiled.const(host.copy()) is made

    def body(branch):
        with compiled._body_of(s, "capture"):
            return compiled.const(np.arange(4, dtype=np.float32))

    with pytest.raises(compiled.Uncapturable,
                       match=r"module 'rings' has no compiled step: a host "
                             r"value of shape \(4,\)"):
        s.run("first", body)


# -- the while setter's plain version ------------------------------------------

@pytest.mark.parametrize("where", ["none", "first", "last", "many"])
def test_while_condition_on_an_odd_plane(where):
    """``condition_plain`` (what the setter computes, and the CPU's
    loop condition) on a 37 x 53 plane, 1961 bytes, not a multiple of
    16 (the kernel reads its last byte apart): any pixel active and the
    fuel below the cap; ``graph_while.run`` on the CPU stops there."""
    rng = np.random.default_rng(11)
    plane = np.zeros((37, 53), bool)
    if where == "many":
        plane = rng.random((37, 53)) < 0.3
    elif where != "none":
        plane.reshape(-1)[0 if where == "first" else -1] = True
    act = torch.from_numpy(plane.copy())
    for f, cap in ((0, 10), (9, 10), (10, 10)):
        fuel = torch.full((1,), f, dtype=torch.int32)
        got = graph_while.condition_plain(act, fuel, cap)
        assert bool(got) == (bool(plane.any()) and f < cap), (where, f)
    fuel = torch.zeros(1, dtype=torch.int32)

    def body():
        act.view(-1)[act.view(-1).nonzero()[:1]] = False
        fuel.add_(1)

    graph_while.run(act, fuel, 1000, body)
    assert int(fuel) == int(plane.sum()) and not act.any()

"""The port's compiled steps (``glava_tpu_torch.compiled``) against the JAX
package's jitted, donated steps.

On the CPU a compiled step runs its static-buffer body eagerly (there is
no CUDA graph on the CPU): the same code a card captures and replays.
Each case feeds both packages the same seeded numpy inputs:

* every native module's ``Renderer.jit_step(quantize=True)`` (and the
  yuv420 wire, and bars on the CPU path) against JAX's ``jit_step``
  over a schedule of 8 frames with ``modified`` true and false, ``time``,
  ``interp_mod`` and ``gravity_g`` changing and a pipe write halfway:
  the golden rule (under 0.2% of pixels, or YUV bytes, more than 2 LSB
  apart), and byte-equal to the port's own eager step on every frame;
* ``AudioPipeline.jit_update`` against JAX's ``jit_update``: spectra
  within 2e-5 (tests/test_fused.py:38) and textures within 5e-5 (the
  JAX suite's texture tolerance);
* S = 4 fleets (bars, circle, a mixed bars/radial/wave fleet) with a
  staggered per-stream ``modified`` mask against JAX's jitted fleet
  step, and byte-equal to the port's eager fleet step;
* the sync guard: after warm-up, each native module's compiled step
  (and the fleet's) with ``Tensor.item``, ``tolist``, ``__bool__``,
  ``__float__``, ``__int__``, ``numpy`` and ``cpu`` patched to raise,
  and the body run with ``torch.as_tensor``/``torch.tensor``/
  ``torch.from_numpy`` of host data patched to raise (a host-to-device
  copy inside a graph);
* the compiled step of a shader module, and the Engine's step of a
  native, a shader and a user Python module (vu_meter; the rest of the
  user modules' cases are ``tests/test_torch_compiled_user.py``'s);
* on the card (``cuda``-marked, skipped here): replays against eager.
"""

from __future__ import annotations

import contextlib
import functools
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glava_tpu.config import loader as jloader
from glava_tpu.parallel.batch import BatchedRenderer as JaxBatched
from glava_tpu.parallel.batch import MixedBatchedRenderer as JaxMixed
from glava_tpu.pipeline import AudioPipeline as JaxPipeline
from glava_tpu.pipeline import UniformSpec as JaxUniform
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu_torch import compiled, interop
from glava_tpu_torch.config import loader
from glava_tpu_torch.parallel import BatchedRenderer, MixedBatchedRenderer
from glava_tpu_torch.pipeline import AudioPipeline, UniformSpec
from glava_tpu_torch.renderer import CompiledStep, Renderer
from glava_tpu_torch.runtime import sinks
from glava_tpu_torch.runtime.engine import Engine, EngineOptions, FrameFetch
from glava_tpu_torch.runtime.fleet import FleetEngine, StreamSpec
from tests.test_glsl_shader import EQ_FRAG
from tests.test_golden import TINY_KNOBS

NATIVE = ("bars", "radial", "circle", "wave", "graph", "test")
REQS = ("setgeometry 0 0 96 64", "setprintframes false", "setbufsize 1024",
        "setsamplesize 256")
CPU_PATH = ("setaccelfft false", "setinterpolate true")
# (modified, time, interp_mod, gravity_g) a frame; the pipe's fg changes
# from frame PIPE_WRITE on
SCHEDULE = tuple((m, 0.1 * k, 0.25 + 0.1 * k, 0.03 + 0.01 * k)
                 for k, m in enumerate((True, True, False, True, False, False,
                                        True, True)))
PIPE_WRITE = 4
FG = (np.float32([0.1, 0.9, 0.3, 1.0]), np.float32([0.8, 0.2, 0.6, 1.0]))
BG = np.float32([0.7, 0.2, 0.5, 1.0])
CHAIN = ("window", "fft", "gravity", "avg")
S = 4


def golden_fraction(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    return float((np.abs(got.astype(np.int16) - want.astype(np.int16)) > 2)
                 .mean())


def _loads(module, tmp_path, extra=(), pipe_values=None):
    """(port, JAX) loads of ``module`` at 96x64, bufsize 1024, with
    test_golden's small-radius knobs, the pipe's names bound to its
    first values."""
    kw = dict(cli_requests=REQS + tuple(extra), force_module=module)
    if pipe_values is not None:
        kw["pipe_values"] = pipe_values
    if module in TINY_KNOBS:
        d = tmp_path / module
        d.mkdir(exist_ok=True)
        (d / f"{module}.glsl").write_text(TINY_KNOBS[module])
        kw["user_dir"] = d
    if module == "eq":
        d = tmp_path / "shaders"
        (d / "eq").mkdir(parents=True, exist_ok=True)
        (d / "eq" / "1.frag").write_text(EQ_FRAG)
        kw["user_dir"] = d
    return loader.load(**dict(kw)), jloader.load(**dict(kw))


def _pipe(k: int) -> dict:
    return {"fg": FG[k >= PIPE_WRITE], "bg": BG}


def _bound() -> dict:
    return {"fg": tuple(float(x) for x in FG[0]),
            "bg": tuple(float(x) for x in BG)}


def _snaps(n: int, seed: int = 4) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 1024)) * 0.3).astype(np.float32)
            for _ in range(n)]


# -- single-stream: every native module ------------------------------------

CASES = ([(m, "rgba8", ()) for m in NATIVE]
         + [(m, "yuv420", ()) for m in NATIVE]
         + [("bars", "rgba8", CPU_PATH)])


@pytest.mark.parametrize("module,wire,extra", CASES,
                         ids=[f"{m}-{w}{'-cpu_path' if e else ''}"
                              for m, w, e in CASES])
def test_jit_step_meets_jax_and_the_eager_step(module, wire, extra, tmp_path):
    lc, jlc = _loads(module, tmp_path, extra, _bound())
    r, jr = Renderer(lc, device="cpu"), JaxRenderer(jlc)
    yuv = wire == "yuv420"
    step = r.jit_step(quantize=not yuv, yuv420=yuv)
    eager = r.step_yuv420 if yuv else r.step_u8
    jstep = jr.jit_step(quantize=not yuv, yuv420=yuv)
    cs, es, js = r.init_state(), r.init_state(), jr.init_state()
    for k, (snap, (mod, t, im, g)) in enumerate(zip(_snaps(len(SCHEDULE)),
                                                    SCHEDULE)):
        pipe = _pipe(k)
        cs, got = step(cs, snap, mod, t, im, g, pipe)
        got = got.numpy().copy()
        es, want_e = eager(es, snap, mod, t, im, g, pipe)
        js, want_j = jstep(js, jnp.asarray(snap), mod, np.float32(t),
                           np.float32(im), np.float32(g),
                           {n: jnp.asarray(v) for n, v in pipe.items()})
        assert np.array_equal(got, want_e.numpy()), f"frame {k}"
        frac = golden_fraction(got, np.asarray(want_j))
        assert frac < 0.002, f"frame {k}: {frac:.4%} off"
    assert (got > 0).any()
    # the state the step returns is its own static state, every call
    assert all(a is b for a, b in zip(compiled.leaves(cs),
                                      compiled.leaves(step.step.state)))


def test_jit_step_takes_a_callers_state_in(tmp_path):
    """A state that is not the step's own (a fresh one mid-run) is
    copied into the static buffers: the frame equals the eager step's
    from the same state."""
    lc, _ = _loads("bars", tmp_path)
    r = Renderer(lc, device="cpu")
    step = r.jit_step(quantize=True)
    snaps = _snaps(3)
    st = r.init_state()
    for s in snaps[:2]:
        st, _ = step(st, s, True, 0.0, 1.0, 0.05)
    fresh = r.init_state()
    _, got = step(fresh, snaps[2], True, 0.0, 1.0, 0.05)
    _, want = r.step_u8(r.init_state(), snaps[2], True, 0.0, 1.0, 0.05)
    assert torch.equal(got, want)
    assert not torch.equal(fresh.key_end, step.step.state.key_end)


def test_jit_step_keeps_the_wallpaper_in_static_planes(tmp_path):
    """The ``__bg__`` planes of an xroot composite go into the step's
    static planes: a new tensor reaches the frame, as in the eager
    step."""
    lc, _ = _loads("bars", tmp_path, ('setopacity "xroot"',))
    r = Renderer(lc, device="cpu")
    step = r.jit_step(quantize=True)
    cs, es = r.init_state(), r.init_state()
    for k, snap in enumerate(_snaps(4)):
        bg = torch.full((4, 64, 96), 0.2 * k, dtype=torch.float32)
        pipe = {"__bg__": bg}
        cs, got = step(cs, snap, k != 2, 0.0, 1.0, 0.05, pipe)
        es, want = r.step_u8(es, snap, k != 2, 0.0, 1.0, 0.05, pipe)
        assert torch.equal(got, want), f"frame {k}"


# -- the compiled update -----------------------------------------------------

@pytest.mark.parametrize("bufsize", [256, 1024, 4096])
def test_jit_update_meets_jax(bufsize):
    """7 compiled updates of fresh audio, S = 3 streams with per-stream
    gravity, against JAX's ``jit_update``."""
    reqs = (f"setbufsize {bufsize}", f"setsamplesize {bufsize // 4}",
            "setprintframes false")
    lc = loader.load(cli_requests=reqs, force_module="bars")
    jlc = jloader.load(cli_requests=reqs, force_module="bars")
    uni = [("audio_l", "audio_l", CHAIN), ("audio_r", "audio_r", CHAIN)]
    port = AudioPipeline(lc.cfg, [UniformSpec(*u) for u in uni], device="cpu")
    ref = JaxPipeline(jlc.cfg, [JaxUniform(*u) for u in uni], use_fused=False)
    step, jstep = port.jit_update(), ref.jit_update()
    ps, js = port.init_state((3,)), ref.init_state((3,))
    rng = np.random.default_rng(2)
    for _ in range(7):
        al, ar = (rng.standard_normal((2, 3, bufsize)) * 0.3).astype(np.float32)
        g = rng.uniform(0.02, 0.08, 3).astype(np.float32)
        ps, tp = step(ps, al, ar, None, None, g)
        js, tj = jstep(js, jnp.asarray(al), jnp.asarray(ar),
                       np.float32(lc.cfg.fft_scale),
                       np.float32(lc.cfg.fft_cutoff), jnp.asarray(g))
        assert tp.keys() == tj.keys()
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(tj[k]),
                                       atol=5e-5)
    carried = interop.state_from_jax_numpy(
        {"chains": jax.tree.map(np.asarray, js),
         "key_start": np.zeros(1), "key_end": np.zeros(1)}, lc.cfg, "cpu")
    for name in ("gravity", "avg"):
        np.testing.assert_allclose(getattr(ps, name).numpy(),
                                   getattr(carried.chains, name).numpy(),
                                   atol=2e-5, err_msg=name)
    assert torch.equal(ps.count, carried.chains.count)


def test_jit_update_equals_the_eager_update():
    lc = loader.load(cli_requests=REQS, force_module="bars")
    uni = [UniformSpec("audio_l", "audio_l", CHAIN),
           UniformSpec("audio_r", "audio_r", CHAIN)]
    port = AudioPipeline(lc.cfg, uni, device="cpu")
    step = port.jit_update()
    ps, es = port.init_state((2,)), port.init_state((2,))
    rng = np.random.default_rng(3)
    for _ in range(5):
        al, ar = (rng.standard_normal((2, 2, 1024)) * 0.3).astype(np.float32)
        ps, tp = step(ps, al, ar, None, None, np.float32(0.04))
        es, te = port.update(es, torch.from_numpy(al), torch.from_numpy(ar),
                             gravity_g=np.float32(0.04))
        for k in tp:
            assert torch.equal(tp[k], te[k])


# -- fleets ------------------------------------------------------------------

def _fleet_inputs(rng, it):
    audio = (rng.standard_normal((S, 2, 1024)) * 0.3).astype(np.float32)
    modified = np.array([it % (s + 1) == 0 for s in range(S)])
    g = rng.uniform(0.02, 0.08, S).astype(np.float32)
    return audio, modified, np.zeros(S, np.float32), np.ones(S, np.float32), g


FLEETS = {"bars": ["bars"], "circle": ["circle"],
          "mixed": ["bars", "radial", "wave"]}


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_fleet_jit_step_meets_jax_and_the_eager_step(fleet, tmp_path):
    """8 staggered steps (stream s updates every (s + 1)-th step), per-
    stream gravity and pipe rows with a write halfway."""
    mods = FLEETS[fleet]
    loads = [_loads(m, tmp_path, (), _bound()) for m in mods]
    if len(mods) == 1:
        br = BatchedRenderer(loads[0][0], S, device="cpu")
        jbr = JaxBatched(loads[0][1], S)
    else:
        assign = [0, 1, 2, 1]
        br = MixedBatchedRenderer([p for p, _ in loads], assign, device="cpu")
        jbr = JaxMixed([j for _, j in loads], assign)
    step = br.jit_step(quantize=True)
    jstep = jax.jit(functools.partial(jbr.step, quantize=True))
    cs, es, js = br.init_state(), br.init_state(), jbr.init_state()
    rng = np.random.default_rng(7)
    for it in range(8):
        inputs = _fleet_inputs(rng, it)
        pipe = {k: np.stack([v] * S) for k, v in _pipe(it).items()}
        cs, got = step(cs, *inputs, pipe)
        got = got.numpy().copy()
        es, want_e = br.step(es, *inputs, pipe, quantize=True)
        js, want_j = jstep(js, *(jnp.asarray(x) for x in inputs),
                           {k: jnp.asarray(v) for k, v in pipe.items()})
        assert np.array_equal(got, want_e.numpy()), f"step {it}"
        want_j = np.asarray(want_j)
        for s in range(S):
            frac = golden_fraction(got[s], want_j[s])
            assert frac < 0.002, f"step {it} stream {s}: {frac:.4%} off"
    assert (got > 0).any()


# -- the sync guard ----------------------------------------------------------

_HOST_READS = ("item", "tolist", "__bool__", "__float__", "__int__", "numpy",
               "cpu")


@contextlib.contextmanager
def _no_host_reads():
    """Every way a tensor's value reaches the host raises."""
    saved = {n: getattr(torch.Tensor, n) for n in _HOST_READS}

    def refuse(name):
        def fn(self, *a, **k):
            raise AssertionError(f"host read: Tensor.{name}")
        return fn

    for n in _HOST_READS:
        setattr(torch.Tensor, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


def _no_host_data(body):
    """``body`` with a tensor made from host data refused: inside a
    graph that is a host-to-device copy of a value fixed at capture."""
    made = {n: getattr(torch, n) for n in ("as_tensor", "tensor",
                                           "from_numpy")}

    def guard(name):
        def fn(data, *a, **k):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"host data: torch.{name}")
            return made[name](data, *a, **k)
        return fn

    def run(*a, **k):
        for n in made:
            setattr(torch, n, guard(n))
        try:
            return body(*a, **k)
        finally:
            for n, f in made.items():
                setattr(torch, n, f)

    return run


@pytest.mark.parametrize("extra", [(), CPU_PATH], ids=["accel", "cpu_path"])
@pytest.mark.parametrize("module", NATIVE)
def test_static_step_reads_nothing_on_the_host(module, extra, tmp_path):
    lc, _ = _loads(module, tmp_path, extra, _bound())
    r = Renderer(lc, device="cpu")
    step = r.jit_step(quantize=True)
    st = r.init_state()
    snaps = _snaps(4)
    pipe = _pipe(0)
    for mod in (True, False):          # warm up both branches
        st, _ = step(st, snaps[0], mod, 0.1, 0.5, 0.05, pipe)
    step._body = _no_host_data(step._body)
    with _no_host_reads():
        for k, snap in enumerate(snaps[1:]):
            st, frame = step(st, snap, k != 1, 0.2 * k, 0.5, 0.05, pipe)
    assert frame.dtype == torch.uint8


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_static_fleet_step_reads_nothing_on_the_host(fleet, tmp_path):
    mods = FLEETS[fleet]
    loads = [_loads(m, tmp_path, (), _bound())[0] for m in mods]
    br = (BatchedRenderer(loads[0], S, device="cpu") if len(mods) == 1 else
          MixedBatchedRenderer(loads, [0, 1, 2, 1], device="cpu"))
    step = br.jit_step(quantize=True)
    st = br.init_state()
    rng = np.random.default_rng(1)
    pipe = {k: np.stack([v] * S) for k, v in _pipe(0).items()}
    st, _ = step(st, *_fleet_inputs(rng, 0), pipe)
    step._body = _no_host_data(step._body)
    with _no_host_reads():
        for it in range(1, 4):
            st, frames = step(st, *_fleet_inputs(rng, it), pipe)
    assert frames.shape == (S, 64, 96, 4)


def test_static_update_reads_nothing_on_the_host():
    lc = loader.load(cli_requests=REQS, force_module="bars")
    port = AudioPipeline(lc.cfg, [UniformSpec("audio_l", "audio_l", CHAIN)],
                         device="cpu")
    step = port.jit_update()
    st = port.init_state((2,))
    al = np.zeros((2, 1024), np.float32)
    st, _ = step(st, al, al, None, None, 0.05)
    step._body = _no_host_data(step._body)
    with _no_host_reads():
        st, tex = step(st, al + 0.1, al - 0.1, None, None, 0.05)
    assert tex["audio_l"].shape == (2, 1024)


# -- user Python and shader modules ------------------------------------------

def _vu_root(d: Path) -> Path:
    root = Path(__file__).resolve().parent.parent
    (d / "modules").mkdir(parents=True)
    shutil.copy(root / "glava_tpu_torch" / "examples" / "vu_meter.py",
                d / "modules" / "vu_meter.py")
    (d / "rc.glsl").write_text("#request mod vu_meter\n"
                               "#request setgeometry 0 0 64 48\n")
    return d


def test_shader_modules_have_a_compiled_step(tmp_path):
    """The shader module ``eq`` (an ``@fg`` knob) gets a compiled step,
    one stream and a fleet, byte-equal to the eager step."""
    lc, _ = _loads("eq", tmp_path, (), _bound())
    r = Renderer(lc, device="cpu")
    assert r.module.kind == "shader"
    step = r.jit_step(quantize=True)
    cs, es = r.init_state(), r.init_state()
    for k, snap in enumerate(_snaps(3)):
        cs, got = step(cs, snap, True, 0.1 * k, 1.0, 0.05, _pipe(4 * k))
        es, want = r.step_u8(es, snap, True, 0.1 * k, 1.0, 0.05, _pipe(4 * k))
        assert torch.equal(got, want), f"frame {k}"
    br = BatchedRenderer(lc, 2, device="cpu")
    fs = br.jit_step()
    inputs = _fleet_inputs(np.random.default_rng(0), 0)
    _, got = fs(br.init_state(), *(x[:2] for x in inputs))
    _, want = br.step(br.init_state(), *(x[:2] for x in inputs),
                      quantize=True)
    assert torch.equal(got, want)


def test_engine_runs_the_compiled_step_or_says_why_not(tmp_path, capsys):
    """A native, a shader and a user Python module's (vu_meter) Engine
    step is the compiled step, and nothing is said of an eager step."""
    eng = Engine(EngineOptions(audio_backend="synth", screen=(64, 48),
                               device="cpu", force_module="bars",
                               requests=("setprintframes false",)),
                 sink=sinks.NullSink())
    assert isinstance(eng._step, CompiledStep)
    eng.run(max_frames=3)
    assert eng.frames_rendered == 3
    d = tmp_path / "shaders"
    (d / "eq").mkdir(parents=True)
    (d / "eq" / "1.frag").write_text(EQ_FRAG)
    eng = Engine(EngineOptions(audio_backend="synth", screen=(64, 48),
                               device="cpu", force_module="eq",
                               user_dir=str(d),
                               requests=("setprintframes false",)),
                 sink=sinks.NullSink())
    assert isinstance(eng._step, CompiledStep)
    eng.run(max_frames=2)
    assert eng.frames_rendered == 2
    root = _vu_root(tmp_path / "vu")
    for _ in range(2):
        eng = Engine(EngineOptions(audio_backend="synth", screen=(64, 48),
                                   device="cpu", user_dir=str(root),
                                   requests=("setprintframes false",)),
                     sink=sinks.NullSink())
        assert eng.renderer.module.kind == "python"
        assert isinstance(eng._step, CompiledStep)
        eng.run(max_frames=2)
        assert eng.frames_rendered == 2
    assert "eager" not in capsys.readouterr().err


def test_fleet_engine_frames_equal_the_eager_fleet(tmp_path):
    """FleetEngine's compiled step against the eager fleet on the same
    snapshots: byte-equal frames through ``fetch``."""
    lc, _ = _loads("bars", tmp_path)
    eng = FleetEngine(lc, [StreamSpec(f"s{i}", pipe={"fg": FG[i % 2]})
                           for i in range(S)], device="cpu")
    br = BatchedRenderer(lc, S, device="cpu")
    es = br.init_state()
    rng = np.random.default_rng(9)
    for it in range(4):
        audio, mods, _, interp, g = _fleet_inputs(rng, it)
        got = eng.fetch(eng.step(audio, mods, 0.5, interp, g))
        es, want = br.step(es, audio, mods, np.full(S, 0.5, np.float32),
                           interp, g, eng._pipe_host, quantize=True)
        assert np.array_equal(got, want.numpy()), f"step {it}"


# -- a static frame on its way to the host ------------------------------------

def _fetch_static(device: str, depth: int) -> list[int]:
    """One frame buffer, written anew before each push (as a replay
    overwrites its output), through ``FrameFetch``: each host frame's
    value."""
    fetch = FrameFetch(device, depth)
    frame = torch.zeros((64, 96, 4), dtype=torch.uint8, device=device)
    out = []
    for k in range(6):
        frame.fill_(k)
        out += fetch.push(frame, float(k))
    out += fetch.drain()
    return [int(host[..., 0].max()) for host, _ in out]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_frame_fetch_copies_a_static_frame_out(depth):
    assert _fetch_static("cpu", depth) == list(range(6))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_frame_fetch_ring_on_the_card(depth):
    """On the card the frame goes through a ring of depth + 1 device
    buffers: a frame overwritten after its push still arrives as it
    was."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    assert _fetch_static("cuda", depth) == list(range(6))


# -- no graph torn down inside a capture -------------------------------------

@pytest.mark.parametrize("kind", ["render", "fleet", "update"])
def test_a_compiled_step_dies_without_the_garbage_collector(kind, tmp_path):
    """No reference cycle holds a compiled step (and so its graphs): it
    goes when its owner does, not at a collection that could fall inside
    another graph's capture."""
    import gc
    import weakref

    lc, _ = _loads("bars", tmp_path)
    snap = _snaps(1)[0]
    if kind == "render":
        r = Renderer(lc, device="cpu")
        step = r.jit_step(quantize=True)
        step(r.init_state(), snap, True, 0.0, 1.0, 0.05)
    elif kind == "fleet":
        br = BatchedRenderer(lc, S, device="cpu")
        step = br.jit_step()
        step(br.init_state(), *_fleet_inputs(np.random.default_rng(0), 0))
    else:
        p = AudioPipeline(lc.cfg, [UniformSpec("audio_l", "audio_l", CHAIN)],
                          device="cpu")
        step = p.jit_update()
        step(p.init_state((1,)), snap[:1], snap[1:], None, None, 0.05)
    ref = weakref.ref(step.step)
    gc.disable()
    try:
        del step
        assert ref() is None
    finally:
        gc.enable()


def test_captures_hold_the_garbage_collector_off():
    assert _gc_enabled_inside(nested=False) == (False, True)
    assert _gc_enabled_inside(nested=True) == (False, True)


def _gc_enabled_inside(nested: bool) -> tuple:
    import gc

    with compiled._no_gc():
        if nested:
            with compiled._no_gc():
                pass
        inside = gc.isenabled()
    return inside, gc.isenabled()


# -- launch counts ---------------------------------------------------------

def test_a_replay_adds_the_launches_its_capture_saw():
    from glava_tpu_torch.ops import fused, latch

    before = compiled.read_counters()
    fused.launches += 2
    latch.launches[4] = latch.launches.get(4, 0) + 1
    delta = compiled._counter_delta(before, compiled.read_counters())
    assert delta == {("fused", "launches"): 2, ("latch", "launches"): {4: 1}}
    compiled._restore_counters(before)
    assert compiled.read_counters() == before
    compiled._add_counters(delta)
    compiled._add_counters(delta)
    assert fused.launches == before["fused", "launches"] + 4
    assert latch.launches[4] == before["latch", "launches"].get(4, 0) + 2
    compiled._restore_counters(before)


# -- on the card -----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("module", NATIVE)
def test_replays_equal_the_eager_step_on_the_card(module, tmp_path):
    """24 frames of the schedule (repeated) on the card: every replay
    byte-equal to the eager step, no host sync inside a replay, one
    graph a branch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    lc, _ = _loads(module, tmp_path, (), _bound())
    r = Renderer(lc, device="cuda")
    step = r.jit_step(quantize=True)
    cs, es = r.init_state(), r.init_state()
    snaps = _snaps(24)
    for k in range(24):
        mod, t, im, g = SCHEDULE[k % len(SCHEDULE)]
        pipe = _pipe(0)
        debug = contextlib.nullcontext() if k < 3 else _sync_errors()
        with debug:
            cs, got = step(cs, snaps[k], mod, t, im, g, pipe)
        es, want = r.step_u8(es, snaps[k], mod, t, im, g, pipe)
        assert torch.equal(got, want), f"frame {k}"
    assert step.step.captures == 2


@contextlib.contextmanager
def _sync_errors():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)

"""The port's many-stream path against the JAX package's.

``BatchedRenderer``, ``MixedBatchedRenderer``, ``FleetDynamics`` and
``FleetEngine`` of ``glava_tpu_torch`` on the CPU, fed the same numpy
inputs as the JAX package's (``jax.jit`` of its steps). The
configuration is tests/test_fleet.py's: 96x64, bufsize 1024, radial and
circle with test_golden's small-radius knobs. S = 4 streams update on
staggered clocks (stream s every (s + 1)-th step, as
tests/test_fused.py's per-stream slot test) with per-stream gravity.

Tolerances (the JAX suite's): fused state within 2e-5, textures within
5e-5, frames under the golden rule (under 0.2% of pixels more than 2
LSB apart), per stream; ``FleetDynamics`` exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from glava_tpu.config import loader as jloader
from glava_tpu.parallel.batch import BatchedRenderer as JaxBatched
from glava_tpu.parallel.batch import MixedBatchedRenderer as JaxMixed
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu.runtime.fleet import FleetDynamics as JaxDynamics
from glava_tpu_torch import interop
from glava_tpu_torch.config import loader
from glava_tpu_torch.parallel import BatchedRenderer, MixedBatchedRenderer, example_batch
from glava_tpu_torch.renderer import Renderer
from glava_tpu_torch.runtime.fleet import FleetDynamics, FleetEngine, StreamSpec
from glava_tpu_torch.runtime.sinks import CallbackSink
from tests.test_glsl_shader import EQ_FRAG
from tests.test_golden import TINY_KNOBS

S = 4
REQS = ("setgeometry 0 0 96 64", "setprintframes false", "setbufsize 1024",
        "setsamplesize 256")


SHADER = "eq"      # a user shader module with an `@fg` knob (EQ_FRAG)
NATIVE = ("bars", "radial", "circle", "wave", "graph", "test")


def _loads(module, tmp_path, extra=(), knobs="", **kw):
    """(port, JAX) loads of ``module`` in the fleet configuration, with
    ``knobs`` (``#define`` lines) over its TINY_KNOBS."""
    kw.update(cli_requests=REQS + tuple(extra), force_module=module)
    if module in TINY_KNOBS or knobs:
        d = tmp_path / module
        d.mkdir(exist_ok=True)
        (d / f"{module}.glsl").write_text(TINY_KNOBS.get(module, "") + knobs)
        kw["user_dir"] = d
    if module == SHADER:
        d = tmp_path / "shaders"
        (d / SHADER).mkdir(parents=True, exist_ok=True)
        (d / SHADER / "1.frag").write_text(EQ_FRAG)
        kw["user_dir"] = d
    return loader.load(**kw), jloader.load(**kw)


def _inputs(rng, it, n=S):
    """One step's inputs: seeded audio, the staggered mask, per-stream
    gravity."""
    audio = (rng.standard_normal((n, 2, 1024)) * 0.3).astype(np.float32)
    modified = np.array([it % (s + 1) == 0 for s in range(n)])
    g = rng.uniform(0.02, 0.08, n).astype(np.float32)
    return audio, modified, np.zeros(n, np.float32), np.ones(n, np.float32), g


def golden_fraction(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float((np.abs(got.astype(np.int16) - want.astype(np.int16)) > 2).mean())


def _u8(frame):
    f = np.asarray(frame)
    return f if f.dtype == np.uint8 else np.clip(np.round(f * 255.0), 0, 255).astype(np.uint8)


def _assert_frames(got, want, what):
    got, want = _u8(got.numpy()), _u8(want)
    for s in range(got.shape[0]):
        frac = golden_fraction(got[s], want[s])
        assert frac < 0.002, f"{what}: stream {s} {frac:.4%} of pixels off"


def _assert_state(pstate, jstate, cfg):
    """The JAX state, carried into the port's layout, against the port's."""
    carried = interop.state_from_jax_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    for name in ("gravity", "history", "avg"):
        np.testing.assert_allclose(getattr(pstate.chains, name).numpy(),
                                   getattr(carried.chains, name).numpy(),
                                   atol=2e-5, err_msg=name)
    assert torch.equal(pstate.chains.count, carried.chains.count)
    assert torch.equal(pstate.key_start, carried.key_start)
    assert torch.equal(pstate.key_end, carried.key_end)


def _assert_textures(pipe, jpipe, pstate, jstate):
    kp = pipe.textures_from(pstate.chains, pstate.key_end[:, 0], pstate.key_end[:, 1])
    kj = jpipe.textures_from(jstate.chains, jstate.key_end[:, 0], jstate.key_end[:, 1])
    assert kp.keys() == kj.keys()
    for k in kp:
        np.testing.assert_allclose(kp[k].numpy(), np.asarray(kj[k]), atol=5e-5)


def _pipe(rng, n=S):
    return {"fg": rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32),
            "bg": rng.uniform(0.0, 0.8, (n, 4)).astype(np.float32)}


def _run_pair(module, tmp_path, quantize, pipe=None, steps=12, n=S, extra=(),
              knobs=""):
    """``steps`` staggered steps of the port's fleet and the JAX fleet,
    loaded alike and given the same pipe rows; frames under the golden
    rule every step."""
    lc, jlc = _loads(module, tmp_path, extra, knobs)
    br = BatchedRenderer(lc, n_streams=n, device="cpu")
    jbr = JaxBatched(jlc, n_streams=n)
    jstep = jax.jit(functools.partial(jbr.step, quantize=quantize))
    ps, js = br.init_state(), jbr.init_state()
    rng = np.random.default_rng(11)
    jpipe = {k: jnp.asarray(v) for k, v in (pipe or {}).items()}
    drawn = False
    for it in range(steps):
        audio, mod, t, im, g = _inputs(rng, it, n)
        ps, got = br.step(ps, audio, mod, t, im, g, pipe, quantize=quantize)
        js, want = jstep(js, jnp.asarray(audio), jnp.asarray(mod), jnp.asarray(t),
                         jnp.asarray(im), jnp.asarray(g), jpipe)
        assert got.shape == (n, 64, 96, 4)
        assert got.dtype == (torch.uint8 if quantize else torch.float32)
        _assert_frames(got, want, f"{module} step {it}")
        drawn |= bool((got[..., 3] > 0).any())
    assert drawn
    return br, jbr, ps, js


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("module", ["bars", "radial", "wave"])
def test_batched_renderer_matches_jax(module, quantize, tmp_path):
    br, jbr, ps, js = _run_pair(module, tmp_path, quantize)
    if module != "wave":
        _assert_state(ps, js, br.cfg)
        _assert_textures(br.renderer.pipeline, jbr.renderer.pipeline, ps, js)
    else:
        assert ps.chains.count.numel() == 0 and not js.chains


@pytest.mark.parametrize("module", ["bars", "radial", "wave"])
def test_per_stream_pipe_colours_match_jax(module, tmp_path):
    """fg/bg per stream, against the JAX fleet's step loaded alike and
    given the same rows: the JAX package reads a step's pipe values
    only in the knobs it evaluates inside the pass (bars' COLOR and
    BAR_OUTLINE, radial's COLOR and BAR_OUTLINE) and bakes the load's
    values into the others at build time (radial's OUTLINE, wave's
    BASE_COLOR and OUTLINE), and so does the port."""
    pipe = _pipe(np.random.default_rng(5))
    br, _, _, _ = _run_pair(module, tmp_path, True, pipe, steps=6)
    f = br.step(br.init_state(), *_inputs(np.random.default_rng(12), 0),
                pipe, quantize=True)[1].numpy()
    if module != "wave":        # wave's colours are the load's
        assert not np.array_equal(f[0], f[1])


@pytest.mark.parametrize("module", ["radial", "wave"])
def test_build_time_colours_keep_the_load_values(module, tmp_path):
    """radial's OUTLINE and wave's BASE_COLOR and OUTLINE are evaluated
    once at build time in the JAX module, from the load's values: a
    step's pipe rows leave them as they are. With loads that bind
    nothing and rows that differ a lot from the defaults, the port's
    fleet meets the JAX fleet; radial's ring (OUTLINE only) is the same
    in every stream and wave's whole frame is."""
    pipe = {"fg": np.float32([[1, 0, 0, 1], [0, 0, 1, 1], [0, 1, 0, 1],
                              [1, 1, 0, 1]]),
            "bg": np.float32([[1, 1, 1, 1], [0, 1, 1, 1], [1, 0, 1, 1],
                              [0.5, 0.5, 0.5, 1]])}
    br, _, _, _ = _run_pair(module, tmp_path, True, pipe, steps=4)
    audio = np.zeros((S, 2, 1024), np.float32)      # silence: ring/line only
    f = br.step(br.init_state(), audio, np.ones(S, bool), np.zeros(S),
                np.ones(S), np.full(S, 0.05), pipe, quantize=True)[1].numpy()
    assert (f[..., 3] > 0).any()
    for s in range(1, S):
        assert np.array_equal(f[s], f[0])


def test_single_stream_pipe_colours_match_jax(tmp_path):
    """The single-stream Renderer takes the step's pipe values too."""
    lc, jlc = _loads("bars", tmp_path)
    r = Renderer(lc, device="cpu")
    jr = JaxRenderer(jlc)
    jstep = jr.jit_step(quantize=True)
    pipe = {"fg": np.array([0.9, 0.1, 0.2, 1.0], np.float32)}
    rng = np.random.default_rng(8)
    ps, js = r.init_state(), jr.init_state()
    for _ in range(5):
        snap = (rng.standard_normal((2, 1024)) * 0.3).astype(np.float32)
        ps, got = r.step_u8(ps, snap, True, 0.0, 1.0, 0.05, pipe)
        js, want = jstep(js, jnp.asarray(snap), True, np.float32(0.0),
                         np.float32(1.0), np.float32(0.05),
                         {k: jnp.asarray(v) for k, v in pipe.items()})
    assert golden_fraction(got.numpy(), want) < 0.002
    drawn = got.numpy()[got.numpy()[..., 3] > 0]
    assert drawn.size and drawn[:, :3].mean(axis=0).argmax() == 0   # red


def test_circle_fleet_pipe_rows_match_jax(tmp_path):
    """(Pipe values are taken by every module now.) circle's fleet
    with pipe rows meets the JAX fleet: its one colour, OUTLINE, is
    built from the load's values in both packages."""
    br, _, ps, js = _run_pair("circle", tmp_path, True,
                              _pipe(np.random.default_rng(6), 2), steps=4, n=2)
    assert br.renderer.module.batched
    _assert_state(ps, js, br.cfg)
    # one stream takes the live wallpaper (the reserved `__bg__` key):
    # under xroot opacity the planes reach the composite
    r = Renderer(_loads("bars", tmp_path, ('setopacity "xroot"',))[0],
                 device="cpu")
    bg = np.broadcast_to(np.float32([0.2, 0.4, 0.6, 1.0])[:, None, None],
                         (4, 64, 96)).copy()
    _, frame = r.step_u8(r.init_state(), np.zeros((2, 1024), np.float32),
                         True, 0.0, 1.0, 0.05, {"__bg__": torch.as_tensor(bg)})
    px, n = np.unique(frame.numpy().reshape(-1, 4), axis=0, return_counts=True)
    assert tuple(px[n.argmax()]) == (51, 102, 153, 255)


def test_unbatched_module_renders_per_stream(tmp_path):
    """A user shader module is not batched: the batched renderer runs
    it one stream at a time in the same step, each stream's pipe row in
    the module's env, and meets the JAX vmap."""
    br, jbr, ps, js = _run_pair(SHADER, tmp_path, True,
                                _pipe(np.random.default_rng(13), 3), steps=6, n=3)
    assert not br.renderer.module.batched
    _assert_state(ps, js, br.cfg)


@pytest.mark.parametrize("module", ["circle", "graph", "test", SHADER])
def test_fleet_pipe_rows_match_jax_fleet(module, tmp_path):
    """circle, graph and test take a stream axis and a shader module
    renders stream by stream; with per-stream fg/bg rows each meets the
    JAX fleet's vmapped step, loaded alike."""
    br, _, ps, js = _run_pair(module, tmp_path, True,
                              _pipe(np.random.default_rng(14)), steps=5)
    assert br.renderer.module.batched == (module != SHADER)
    _assert_state(ps, js, br.cfg)


# knob variants whose passes take the stream axis on other branches
FLEET_VARIANTS = {
    "graph-anti_alias": "#define ANTI_ALIAS 1\n",
    "graph-join_invert": "#define JOIN_CHANNELS 1\n#define INVERT 1\n",
    "graph-anti_alias_invert_outline": ("#define ANTI_ALIAS 1\n#define INVERT 1\n"
                                        "#define DRAW_OUTLINE 1\n"),
    "circle-fill": "#define C_FILL 1\n",
    "circle-no_smooth": "#define C_SMOOTH 0\n",
    "radial-bar_outline": "#define BAR_OUTLINE_WIDTH 1\n",
}


@pytest.mark.parametrize("variant", sorted(FLEET_VARIANTS))
def test_fleet_knob_variants_match_jax_fleet(variant, tmp_path):
    """Knob variants of the batched modules in a fleet with fg/bg rows,
    against the JAX fleet loaded alike (golden rule per stream)."""
    module = variant.split("-", 1)[0]
    _run_pair(module, tmp_path, True, _pipe(np.random.default_rng(18), 3),
              steps=5, n=3, knobs=FLEET_VARIANTS[variant])


def test_circle_fleet_is_one_lookup_a_frame(tmp_path, monkeypatch):
    """circle's fleet frame is one table lookup for every stream: the
    (S, 2 sz) tables against the one static plane."""
    from glava_tpu_torch.ops import lookup

    calls = []
    plain = lookup.table_lookup_plain
    monkeypatch.setattr(lookup, "table_lookup_plain",
                        lambda t, i: calls.append(tuple(t.shape)) or plain(t, i))
    lc, _ = _loads("circle", tmp_path)
    br = BatchedRenderer(lc, n_streams=S, device="cpu")
    br.step(br.init_state(), *_inputs(np.random.default_rng(1), 0),
            quantize=True)
    assert calls == [(S, 2 * br.renderer.pipeline.sz)]


def test_mixed_fleet_matches_jax(tmp_path):
    """bars + radial + wave streams in one step, interleaved assignment;
    each stream gets its own variant's frame, in stream order."""
    mods = ["bars", "radial", "wave"]
    loads = [_loads(m, tmp_path) for m in mods]
    assign = [0, 1, 2, 1, 0]
    n = len(assign)
    mx = MixedBatchedRenderer([p for p, _ in loads], assign, device="cpu")
    jmx = JaxMixed([j for _, j in loads], assign)
    jstep = jax.jit(functools.partial(jmx.step, quantize=True))
    ps, js = mx.init_state(), jmx.init_state()
    rng = np.random.default_rng(7)
    for it in range(8):
        audio, mod, t, im, g = _inputs(rng, it, n)
        ps, got = mx.step(ps, audio, mod, t, im, g, quantize=True)
        js, want = jstep(js, jnp.asarray(audio), jnp.asarray(mod),
                         jnp.asarray(t), jnp.asarray(im), jnp.asarray(g), {})
        _assert_frames(got, want, f"mixed step {it}")
    _assert_state(ps, js, mx.cfg)
    f = got.numpy()
    assert all((f[s][..., 3] > 0).any() for s in range(n))
    assert not np.array_equal(f[0], f[1]) and not np.array_equal(f[1], f[2])


def test_mixed_fleet_of_every_module_matches_jax(tmp_path):
    """The six native modules and a shader module in one mixed fleet,
    each stream with its own fg/bg row, against the JAX mixed fleet
    loaded alike: frames per stream under the golden rule."""
    mods = NATIVE + (SHADER,)
    loads = [_loads(m, tmp_path) for m in mods]
    assign = [0, 1, 2, 3, 4, 5, 6, 1, 6, 2]
    n = len(assign)
    pipe = _pipe(np.random.default_rng(15), n)
    mx = MixedBatchedRenderer([p for p, _ in loads], assign, device="cpu")
    jmx = JaxMixed([j for _, j in loads], assign)
    jstep = jax.jit(functools.partial(jmx.step, quantize=True))
    jpipe = {k: jnp.asarray(v) for k, v in pipe.items()}
    ps, js = mx.init_state(), jmx.init_state()
    rng = np.random.default_rng(16)
    for it in range(5):
        audio, mod, t, im, g = _inputs(rng, it, n)
        ps, got = mx.step(ps, audio, mod, t, im, g, pipe, quantize=True)
        js, want = jstep(js, *(jnp.asarray(a) for a in (audio, mod, t, im, g)),
                         jpipe)
        _assert_frames(got, want, f"mixed step {it}")
    _assert_state(ps, js, mx.cfg)
    assert all((got[s][..., 3] > 0).any() for s in range(n))


def test_mixed_fleet_pipe_rows_follow_their_streams(tmp_path):
    """With per-stream pipe values, stream s of the mixed fleet renders
    as a one-stream fleet of its variant given row s."""
    mods = ["bars", "radial", "wave"]
    loads = [_loads(m, tmp_path)[0] for m in mods]
    assign = [0, 1, 2, 1, 0]
    n = len(assign)
    pipe = _pipe(np.random.default_rng(9), n)
    mx = MixedBatchedRenderer(loads, assign, device="cpu")
    ones = [BatchedRenderer(loads[a], n_streams=1, device="cpu") for a in assign]
    ps = mx.init_state()
    ss = [b.init_state() for b in ones]
    rng = np.random.default_rng(10)
    for it in range(4):
        audio, mod, t, im, g = _inputs(rng, it, n)
        ps, got = mx.step(ps, audio, mod, t, im, g, pipe, quantize=True)
        for s, b in enumerate(ones):
            ss[s], want = b.step(ss[s], *(a[s:s + 1] for a in (audio, mod, t, im, g)),
                                 {k: v[s:s + 1] for k, v in pipe.items()},
                                 quantize=True)
            _assert_frames(got[s:s + 1], want.numpy(), f"stream {s} step {it}")


def test_mixed_fleet_rejects_dsp_mismatch(tmp_path):
    a, _ = _loads("bars", tmp_path)
    b, _ = _loads("wave", tmp_path, extra=("setbufsize 2048",))
    with pytest.raises(ValueError, match="bufsize"):
        MixedBatchedRenderer([a, b], [0, 1], device="cpu")


def test_fleet_dynamics_match_jax():
    """tests/test_fleet.py's throttled-clock sequence through both
    copies: every output identical."""
    nominal = 86.1328125
    dyn, jdyn = FleetDynamics(2, nominal, 60), JaxDynamics(2, nominal, 60)

    def same(a, b):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    for i in range(60):
        m = np.array([True, i % 4 == 0])
        same(dyn.frame(m, fps=60.0), jdyn.frame(m, fps=60.0))
    same(dyn.tick(1.0), jdyn.tick(1.0))
    np.testing.assert_allclose(dyn.ups, [60.0, 15.0])
    same(dyn.gravity(4.2), jdyn.gravity(4.2))
    for i in range(4):
        m = np.array([True, i == 0])
        same(dyn.frame(m, fps=60.0), jdyn.frame(m, fps=60.0))
    same(dyn.tick(1.0), jdyn.tick(1.0))
    same(dyn.gravity(4.2), jdyn.gravity(4.2))
    same(dyn.kcounter, jdyn.kcounter)


def _fleet_load():
    return loader.load(cli_requests=REQS)


def test_fleet_engine_per_stream_sources_and_colours():
    streams = [
        StreamSpec("a", source="synth:300,900",
                   pipe={"fg": (1, 0, 0, 1), "bg": (0, 0, 0, 0)}),
        StreamSpec("b", source="synth:noise",
                   pipe={"fg": (0, 0, 1, 1), "bg": (0, 0, 0, 0)}),
    ]
    f = FleetEngine(_fleet_load(), streams, device="cpu")
    f.run(max_seconds=1.5)
    fa, fb = f.tex(0), f.tex(1)
    assert fa is not None and fb is not None and fa.shape == (64, 96, 4)
    da, db = fa[fa[..., 3] > 0], fb[fb[..., 3] > 0]
    assert da.size and db.size
    assert da[:, :3].mean(axis=0).argmax() == 0  # red stream
    assert db[:, :3].mean(axis=0).argmax() == 2  # blue stream
    assert not np.array_equal(fa, fb)


def test_fleet_engine_live_pipe_update():
    streams = [StreamSpec("a", source="synth:500,1500",
                          pipe={"fg": (1, 0, 0, 1), "bg": (0, 0, 0, 0)})]
    f = FleetEngine(_fleet_load(), streams, device="cpu")
    f.set_pipe(0, "fg", (0, 1, 0, 1))
    f.run(max_seconds=1.0)
    fr = f.tex(0)
    drawn = fr[fr[..., 3] > 0]
    assert drawn.size
    assert drawn[:, 1].min() == 255  # updated to green before the run
    f.set_pipe(0, "fg", (0, 0, 1, 1))
    frames = f.step(np.zeros((1, 2, 1024), np.float32), np.zeros(1, bool), 0.0,
                    np.ones(1, np.float32), np.full(1, 0.05, np.float32))
    drawn = frames[0][frames[0][..., 3] > 0].numpy()
    assert drawn.size and drawn[:, 2].min() == 255 and drawn[:, 1].max() == 0


def test_fleet_engine_heterogeneous_modules(tmp_path):
    shared, _ = _loads("bars", tmp_path)
    radial, _ = _loads("radial", tmp_path)
    wave, _ = _loads("wave", tmp_path)
    streams = [StreamSpec("a", source="synth:400,800"),
               StreamSpec("b", source="synth:400,800", loaded=radial),
               StreamSpec("c", source="synth:400,800", loaded=wave)]
    f = FleetEngine(shared, streams, device="cpu")
    assert isinstance(f.br, MixedBatchedRenderer)
    f.run(max_frames=20, max_seconds=30.0)
    frames = [f.tex(i) for i in range(3)]
    assert all(fr is not None and (fr[..., 3] > 0).any() for fr in frames)
    assert not np.array_equal(frames[0], frames[1])
    assert not np.array_equal(frames[1], frames[2])


def _queued_fleet(device, n=S):
    """A fleet whose sinks keep every (frame, time) handed off and a copy
    made as it was handed off; its step records its inputs (the audio
    buffer is the loop's, rewritten every frame: copied)."""
    kept = [[] for _ in range(n)]

    def keep(i):
        return CallbackSink(lambda f, t: kept[i].append((f, t, np.array(f))))

    fleet = FleetEngine(_fleet_load(), [
        StreamSpec(f"s{i}", source=f"synth:{300 + 150 * i},900", sink=keep(i),
                   pipe={"fg": (1, 0.2 * i, 0, 1)}) for i in range(n)],
        device=device)
    calls, step = [], fleet._step

    def recording(state, audio, *rest):
        calls.append((audio.clone(),) + tuple(
            {k: v.copy() for k, v in a.items()} if isinstance(a, dict)
            else np.array(a) for a in rest))
        return step(state, audio, *rest)

    fleet._step = recording
    return fleet, kept, calls


def _sync_frames(device, calls) -> list:
    """What a fresh fleet's step and synchronous ``fetch(frames)`` give
    for the recorded inputs."""
    fresh, _, _ = _queued_fleet(device)
    out = []
    for args in calls:
        fresh.state, frames = fresh._step(fresh.state, *args)
        out.append(fresh.fetch(frames))
    return out


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("frames", [1, 6])
def test_fleet_run_hands_off_every_frame_in_step_order(device, frames):
    """An unsharded fleet's run keeps one frame in flight
    (``FrameFetch``, depth 1): every sink gets exactly one frame a step,
    in step order, each with its own step's time, the last before
    ``run`` returns; each byte-equal to what the synchronous step and
    ``fetch(frames)`` give for the same inputs, and still equal, when
    the run ends, to what it was when handed off (on the card the
    newest steps ran after it)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    fleet, kept, calls = _queued_fleet(device)
    fleet.run(max_frames=frames)
    assert len(calls) == frames and fleet._inflight is None
    want = _sync_frames(device, calls)
    for i, got in enumerate(kept):
        assert len(got) == frames
        # the step takes each frame's time as float32
        assert [np.float32(t) for _, t, _ in got] == [c[2][i] for c in calls]
        for k, (frame, _, copy) in enumerate(got):
            assert frame.tobytes() == copy.tobytes() == want[k][i].tobytes(), (i, k)
    assert len({id(f) for f, _, _ in kept[0]}) == frames


def test_a_second_fleet_run_starts_with_an_empty_queue():
    """Each run drains its own frame in flight: after a run of 3 frames
    every sink holds 3, and a second run up to 5 frames adds 2."""
    fleet, kept, calls = _queued_fleet("cpu")
    fleet.run(max_frames=3)
    assert [len(k) for k in kept] == [3] * S and fleet._inflight is None
    fleet.run(max_frames=5)
    assert [len(k) for k in kept] == [5] * S and len(calls) == 5
    want = _sync_frames("cpu", calls)
    for i, got in enumerate(kept):
        assert [f.tobytes() for f, _, _ in got] == [w[i].tobytes() for w in want]


def test_fleet_fetch_outside_a_run_returns_the_frames_at_once():
    """``fetch(frames)`` outside a run returns that step's frames;
    ``fetch(frames, t)`` there returns them with ``t``, at once."""
    fleet, _, _ = _queued_fleet("cpu")
    cfg = fleet.loaded.cfg
    args = (np.zeros((S, 2, cfg.bufsize), np.float32), np.ones(S, bool), 0.5,
            np.ones(S, np.float32), np.full(S, 0.05, np.float32))
    frames = fleet.step(*args)
    host = fleet.fetch(frames)
    assert isinstance(host, np.ndarray) and np.array_equal(host, frames.numpy())
    ((again, t),) = fleet.fetch(frames, 0.5)
    assert t == 0.5 and np.array_equal(again, host)


@pytest.mark.parametrize("modified", [True, False])
def test_batched_state_carries_over_from_jax(modified, tmp_path):
    """A JAX batched state (S = 4, five staggered steps; its ring layout
    with a per-stream count) carried into the port: the next three
    frames of both meet the golden rule, and the states the tolerances."""
    lc, jlc = _loads("bars", tmp_path)
    br = BatchedRenderer(lc, n_streams=S, device="cpu")
    jbr = JaxBatched(jlc, n_streams=S)
    jstep = jax.jit(functools.partial(jbr.step, quantize=True))
    js = jbr.init_state()
    rng = np.random.default_rng(13)
    for it in range(5):
        audio, mod, t, im, g = _inputs(rng, it)
        js, _ = jstep(js, *(jnp.asarray(a) for a in (audio, mod, t, im, g)), {})
    assert "__xla__" in js.chains and js.chains["__xla__"].count.shape == (S,)
    ps = interop.state_from_jax_numpy(jax.tree.map(np.asarray, js), lc.cfg, "cpu")
    for it in range(5, 8):
        audio, mod, t, im, g = _inputs(rng, it)
        mod = mod if modified else np.zeros(S, bool)
        ps, got = br.step(ps, audio, mod, t, im, g, quantize=True)
        js, want = jstep(js, *(jnp.asarray(a) for a in (audio, mod, t, im, g)), {})
        _assert_frames(got, want, f"carried step {it}")
    _assert_state(ps, js, lc.cfg)


def test_batched_state_round_trips_through_numpy(tmp_path):
    lc, _ = _loads("bars", tmp_path)
    br = BatchedRenderer(lc, n_streams=S, device="cpu")
    ex = example_batch(br, 3)
    state = br.init_state()
    rng = np.random.default_rng(2)
    for it in range(4):
        _, mod, _, _, g = _inputs(rng, it)
        state, _ = br.step(state, ex["audio"], mod, ex["time"],
                           ex["interp_mod"], g, quantize=True)
    leaves = interop.state_to_numpy(state)
    assert leaves["chains"]["__fused__"]["count"].shape == (2 * S,)
    back = interop.state_from_jax_numpy(leaves, lc.cfg, "cpu")
    for a, b in zip(back.chains, state.chains):
        assert torch.equal(a, b)
    assert torch.equal(back.key_end, state.key_end)
    # rows s * U + u: each stream's two uniforms share its count
    count = state.chains.count.reshape(S, 2)
    assert torch.equal(count[:, 0], count[:, 1])
    assert count[:, 0].tolist() == [4 % 6, 2, 2, 1]


def test_update_textures_match_the_step(tmp_path):
    lc, _ = _loads("bars", tmp_path)
    br = BatchedRenderer(lc, n_streams=S, device="cpu")
    ex = example_batch(br)
    chains, tex = br.update_textures(br.init_state().chains, ex["audio"],
                                     ex["gravity_g"])
    state, _ = br.step(br.init_state(), ex["audio"], ex["modified"], ex["time"],
                       ex["interp_mod"], ex["gravity_g"])
    want = br.renderer.pipeline.textures_from(state.chains, ex["audio"][:, 0],
                                              ex["audio"][:, 1])
    for k in want:
        assert tex[k].shape == (S, br.renderer.pipeline.sz)
        assert torch.equal(tex[k], want[k])


@pytest.mark.cuda
def test_cuda_fleet_meets_cpu_fleet(tmp_path):
    """On the card the fleet launches the fused update once (B = 2 S)
    and the bars raster once a frame; its frames meet the CPU fleet's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from glava_tpu_torch.ops import fused, raster

    lc, _ = _loads("bars", tmp_path)
    frames = {}
    for dev in ("cpu", "cuda"):
        br = BatchedRenderer(lc, n_streams=S, device=dev)
        state = br.init_state()
        rng = np.random.default_rng(3)
        f0, r0 = fused.launches, raster.launches
        for it in range(6):
            audio, mod, t, im, g = _inputs(rng, it)
            state, fr = br.step(state, audio, mod, t, im, g, quantize=True)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert fused.launches - f0 == 6 and raster.launches - r0 == 6
        frames[dev] = fr.cpu()
    _assert_frames(frames["cuda"], frames["cpu"].numpy(), "cuda vs cpu")


def test_batched_fused_layout_carries_over(tmp_path):
    """The JAX package's other batched layout: its fused update (the
    Pallas kernel in interpret mode, as tests/test_fused.py runs it)
    keeps a flat ``__fused__`` state with per-row counts; carried into
    the port after staggered steps, the next frames and states meet."""
    from glava_tpu.ops.pallas import fused as jfused

    lc, jlc = _loads("bars", tmp_path)
    jbr = JaxBatched(jlc, n_streams=S)
    jp = jbr.renderer.pipeline
    jp.use_fused = True
    jp._fused = jfused.build_fused_update_inc(
        jp.sz, jlc.cfg.avg_frames,
        tuple(float(x) for x in np.asarray(jp.avg_weights)),
        batch_tile=4, interpret=True)
    jstep = jax.jit(functools.partial(jbr.step, quantize=True))
    js = jbr.init_state()
    assert js.chains["__fused__"].count.shape == (2 * S,)
    rng = np.random.default_rng(17)
    for it in range(4):
        audio, mod, t, im, g = _inputs(rng, it)
        js, _ = jstep(js, *(jnp.asarray(a) for a in (audio, mod, t, im, g)), {})
    br = BatchedRenderer(lc, n_streams=S, device="cpu")
    ps = interop.state_from_jax_numpy(jax.tree.map(np.asarray, js), lc.cfg, "cpu")
    for it in range(4, 6):
        audio, mod, t, im, g = _inputs(rng, it)
        ps, got = br.step(ps, audio, mod, t, im, g, quantize=True)
        js, want = jstep(js, *(jnp.asarray(a) for a in (audio, mod, t, im, g)), {})
        _assert_frames(got, want, f"fused-layout step {it}")
    _assert_state(ps, js, lc.cfg)

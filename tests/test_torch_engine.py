"""The port's host runtime against the JAX package's: the stdin pipe
protocol, the frame's way to the host (wire choice, device YUV420
packing, the in-flight queue), pipe values for every module, the
``setbgimg`` wallpaper, the embedding API, the capture backends and the
native ring.

Tolerances (the JAX suite's): frames under the golden rule (under 0.2%
of pixels more than 2 LSB apart, ``tests/test_golden.py``), YUV planes
within 1 LSB (float32 operation order, ``tests/test_runtime.py``),
host-side parsing, byte formats and the native ring exactly.
"""

from __future__ import annotations

import io
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from glava_tpu.config import loader as jloader
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu.renderer import yuv420_pack_planes as jyuv420_planes
from glava_tpu.runtime import stdin_pipe as jpipe
from glava_tpu.runtime.engine import Engine as JaxEngine
from glava_tpu_torch import api, native
from glava_tpu_torch.config import loader
from glava_tpu_torch.renderer import (
    Renderer, yuv420_pack, yuv420_pack_host, yuv420_pack_planes,
)
from glava_tpu_torch.runtime import audio as audio_mod
from glava_tpu_torch.runtime import sinks, stdin_pipe
from glava_tpu_torch.runtime.engine import (
    Engine, EngineOptions, FrameFetch, choose_wire, inflight_depth,
)
from tests.test_glsl_shader import EQ_FRAG
from tests.test_golden import TINY_KNOBS

REQS = ("setgeometry 0 0 96 64", "setprintframes false", "setbufsize 1024",
        "setsamplesize 256")


def golden_fraction(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float((np.abs(got.astype(np.int16) - want.astype(np.int16)) > 2).mean())


# ---------------------------------------------------------------------------
# the stdin pipe protocol (render.c:1861-2005)
# ---------------------------------------------------------------------------

PARSE_CASES = {
    "int": ["42", " -7 ", "12abc", "+3", "-", "x", "0x10", ""],
    "float": ["1.5", "-2e-3", " 7 ", "nan", "abc", "1.5.2"],
    "bool": ["true", "TRUE", "True", "1", "false", "FALSE", "False", "0",
             "yes", "2"],
    "vec2": ["1.0,2.0", "1", "a,3", " 4 , 5 ", "1,2,3"],
    "vec3": ["1,2,3", "0.5,,0.25", "#ff0000"],
    "vec4": ["1,2,3,4", "#ff000080", "#00ff00", "#fff", "#zz", "0.1,0.2"],
}


def _outcome(fn, *args):
    try:
        return ("ok", repr(fn(*args)))   # repr: nan == nan
    except (KeyError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("stype", stdin_pipe.VALID_TYPES)
def test_parse_value_matches_jax(stype):
    assert stdin_pipe.VALID_TYPES == jpipe.VALID_TYPES
    for text in PARSE_CASES[stype]:
        assert _outcome(stdin_pipe.parse_value, stype, text) == \
            _outcome(jpipe.parse_value, stype, text), (stype, text)


@pytest.mark.parametrize("stype", stdin_pipe.VALID_TYPES)
def test_parse_line_matches_jax(stype):
    for binds_of in (lambda m: {"u": m.PipeBind("u", stype),
                                "_": m.PipeBind("_", stype)},
                     lambda m: {"STDIN": m.PipeBind("STDIN", stype)}):
        ours, theirs = binds_of(stdin_pipe), binds_of(jpipe)
        assert [b.default_value() for b in ours.values()] == \
            [b.default_value() for b in theirs.values()]
        for text in PARSE_CASES[stype]:
            for line in (f"u = {text}\n", f"  u={text}", text, "nope = 1", ""):
                assert _outcome(stdin_pipe.parse_line, line, ours) == \
                    _outcome(jpipe.parse_line, line, theirs), (stype, line)


def test_pipe_reader_thread():
    stream = io.StringIO("amp = 0.5\nbogus = 3\namp = 0.9\n")
    r = stdin_pipe.PipeReader([stdin_pipe.PipeBind("amp", "float")], stream)
    r.start()
    for _ in range(200):
        if r.eof:
            break
        time.sleep(0.01)
    assert r.snapshot() == {"amp": 0.9}


def test_cli_parses_pipe_and_stdin():
    from glava_tpu.cli import build_parser as jparser
    from glava_tpu_torch.cli import build_parser

    argv = ["-v", "-d", "-r", "setframerate 30", "-m", "graph", "-a", "synth",
            "-p", "fg", "-p", "amp:float", "--stdin", "vec4", "--sink", "null",
            "--frames", "10", "--size", "640x360"]
    a, j = build_parser().parse_args(argv), jparser().parse_args(argv)
    for k in ("verbose", "desktop", "request", "force_mod", "audio", "stdin",
              "frames", "size"):
        assert getattr(a, k) == getattr(j, k), k
    assert [(b.name, b.stype) for b in a.pipe] == \
        [(b.name, b.stype) for b in j.pipe] == [("fg", "vec4"), ("amp", "float")]
    assert build_parser().parse_args([]).audio is None   # JAX's default


# ---------------------------------------------------------------------------
# the frame's way to the host
# ---------------------------------------------------------------------------

def _jax_wire(sink_wire: str, w: int, h: int, test_mode: bool) -> tuple:
    """The JAX engine's own rule (``Engine._build_step``) on stubs."""
    e = JaxEngine.__new__(JaxEngine)
    e.sink = SimpleNamespace(wire_format=sink_wire)
    e.opts = SimpleNamespace(test_mode=test_mode)
    e.renderer = SimpleNamespace(screen=(w, h), jit_step=lambda **kw: None)
    e._build_step()
    return e._wire


@pytest.mark.parametrize("sink_wire", ["rgba8", "yuv420"])
@pytest.mark.parametrize("size", [(1920, 1080), (1024, 512), (1022, 512),
                                  (1921, 1080), (1920, 1081), (800, 600),
                                  (2, 262144), (1024, 511)])
@pytest.mark.parametrize("test_mode", [False, True])
def test_wire_choice_matches_jax(sink_wire, size, test_mode):
    w, h = size
    assert choose_wire(sink_wire, w, h, test_mode) == \
        _jax_wire(sink_wire, w, h, test_mode)


def test_shipped_size_stays_rgba8():
    assert choose_wire("yuv420", 800, 600, False) == ("rgba8",)
    assert choose_wire("yuv420", 1920, 1080, False) == ("yuv420", 1920, 1080)


def test_inflight_override(monkeypatch, capsys):
    monkeypatch.setenv("GLAVA_TPU_INFLIGHT", "3")
    assert inflight_depth(1) == 3
    monkeypatch.setenv("GLAVA_TPU_INFLIGHT", "two")
    assert inflight_depth(2) == 2
    assert "ignoring malformed GLAVA_TPU_INFLIGHT='two'" in capsys.readouterr().err
    monkeypatch.delenv("GLAVA_TPU_INFLIGHT")
    assert inflight_depth(-1) == 0


@pytest.mark.parametrize("h,w", [(8, 12), (64, 48), (1080, 1920)])
def test_yuv420_pack_planes_matches_jax(h, w):
    """Seeded planes (tensors and a numpy constant plane, as a pass
    leaves them) through both packs: within 1 LSB."""
    rng = np.random.default_rng(h)
    planes = [rng.random((h, w), dtype=np.float32) for _ in range(2)]
    planes.append(np.float32(0.37))
    planes.append(np.ones((h, w), np.float32))
    got = yuv420_pack_planes(
        [torch.as_tensor(p) for p in planes[:2]] + planes[2:], h, w)
    want = jyuv420_planes([jnp.asarray(p) for p in planes], h, w)
    for g, j in zip(got, want):
        j = np.asarray(j)
        assert g.dtype == torch.uint8 and g.shape == j.shape
        assert np.abs(g.numpy().astype(int) - j.astype(int)).max() <= 1
    # the interleaved form and the host mirror of the quantized frame
    frame = torch.stack([torch.as_tensor(np.broadcast_to(p, (h, w)).copy())
                         for p in planes], -1)
    u8 = torch.clamp(torch.round(frame * 255.0), 0, 255).to(torch.uint8)
    for a, b, c in zip(yuv420_pack(frame), got, yuv420_pack_host(u8.numpy())):
        assert torch.equal(a, b)
        assert np.abs(b.numpy().astype(int) - c.astype(int)).max() <= 1


def _stream_frames(module: str, n: int, screen=(96, 64), yuv: bool = False):
    """n device frames of a seeded run (cpu), from one renderer."""
    kw = dict(cli_requests=REQS, force_module=module)
    r = Renderer(loader.load(**kw), screen=screen, device="cpu")
    rng = np.random.default_rng(3)
    st = r.init_state()
    out = []
    for _ in range(n):
        snap = (rng.standard_normal((2, 1024)) * 0.3).astype(np.float32)
        st, f = (r.step_yuv420 if yuv else r.step_u8)(st, snap, True, 0.0,
                                                      1.0, 0.05)
        out.append(f)
    return out


@pytest.mark.parametrize("depth", [0, 1, 4])
def test_frame_fetch_order_count_and_drain(depth):
    frames = _stream_frames("bars", 7)
    fetch = FrameFetch("cpu", depth)
    got = []
    for i, f in enumerate(frames):
        ready = fetch.push(f, float(i))
        assert len(fetch) == min(i + 1, depth)
        got += ready
    got += fetch.drain()
    assert [t for _, t in got] == [float(i) for i in range(7)]
    for (host, _), f in zip(got, frames):
        assert isinstance(host, np.ndarray) and np.array_equal(host, f.numpy())


def test_frame_fetch_yuv420_views():
    """A yuv420 buffer is handed out as (Y, U, V) views of one host
    buffer, the planes of the packed device frame."""
    w, h = 96, 64
    (buf,) = _stream_frames("bars", 1, yuv=True)
    assert buf.shape == (w * h * 3 // 2,) and buf.dtype == torch.uint8
    fetch = FrameFetch("cpu", 0, ("yuv420", w, h))
    ((y, u, v), _), = fetch.push(buf, 0.0)
    assert (y.shape, u.shape, v.shape) == ((h, w), (h // 2, w // 2),
                                           (h // 2, w // 2))
    assert np.concatenate([y.ravel(), u.ravel(), v.ravel()]).tobytes() == \
        buf.numpy().tobytes()
    # the planes of the same step's RGBA frame, packed on the host
    (rgba,) = _stream_frames("bars", 1)
    for a, b in zip((y, u, v), yuv420_pack_host(rgba.numpy())):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_frame_fetch_equal_across_depths():
    frames = _stream_frames("circle", 5)
    runs = []
    for depth in (0, 1, 4):
        fetch = FrameFetch("cpu", depth)
        got = [h for f in frames for h, _ in fetch.push(f, 0.0)]
        got += [h for h, _ in fetch.drain()]
        runs.append(b"".join(h.tobytes() for h in got))
    assert runs[0] == runs[1] == runs[2]


@pytest.mark.parametrize("depth", [0, 1, 4])
def test_engine_inflight_preserves_order_and_drains(depth):
    """Every rendered frame reaches the sink exactly once, oldest
    first, the tail still queued at exit included (tests/test_runtime.py
    test_engine_inflight_queue_preserves_order_and_drains)."""
    received = []
    eng = Engine(EngineOptions(audio_backend="synth", screen=(64, 48),
                               requests=("setprintframes false",),
                               inflight=depth, device="cpu"),
                 sink=sinks.CallbackSink(lambda f, t: received.append((t, f))))
    eng.run(max_frames=7)
    assert eng.frames_rendered == 7
    assert len(received) == 7
    ts = [t for t, _ in received]
    assert ts == sorted(ts)
    assert received[-1][1].shape == (48, 64, 4)


def test_engine_yuv420_wire_to_y4m(tmp_path):
    """A y4m sink at 1024x512 takes the yuv420 wire: the device packs,
    the sink writes the planes as they come (C420jpeg)."""
    out = tmp_path / "o.y4m"
    sink = sinks.make_sink(f"y4m:{out}")
    eng = Engine(EngineOptions(audio_backend="synth", screen=(1024, 512),
                               requests=("setprintframes false",),
                               device="cpu"), sink=sink)
    assert eng._wire == ("yuv420", 1024, 512)
    eng.run(max_frames=2)
    data = out.read_bytes()
    assert data.startswith(b"YUV4MPEG2 W1024 H512") and b"C420jpeg" in data[:80]
    assert data.count(b"FRAME\n") == 2


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
def test_frame_fetch_pinned_on_cuda(depth):
    """On the card every handed-out buffer is pinned and byte-equal to a
    synchronous copy, with freshly allocated memory written between
    steps (the caching allocator's reuse)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    r = Renderer(loader.load(cli_requests=REQS), device="cuda")
    fetch = FrameFetch("cuda", depth)
    st, want, got = r.init_state(), [], []
    rng = np.random.default_rng(0)
    for i in range(6):
        snap = (rng.standard_normal((2, 1024)) * 0.3).astype(np.float32)
        st, f = r.step_u8(st, snap, True, 0.0, 1.0, 0.05)
        want.append(f.clone())
        got += fetch.push(f, float(i))
        del f
        torch.empty(96 * 64 * 4, dtype=torch.uint8, device="cuda").fill_(7)
    got += fetch.drain()
    for (host, _), w in zip(got, want):
        assert torch.from_numpy(host).is_pinned()
        assert np.array_equal(host, w.cpu().numpy())


# ---------------------------------------------------------------------------
# pipe values for every module
# ---------------------------------------------------------------------------

SHADER = "eq"
PIPE_MODULES = ("bars", "radial", "wave", "circle", "graph", "test", SHADER)


def _module_loads(module, tmp_path, pipe_values):
    kw = dict(cli_requests=REQS, force_module=module, pipe_values=pipe_values)
    if module in TINY_KNOBS:
        d = tmp_path / module
        d.mkdir(exist_ok=True)
        (d / f"{module}.glsl").write_text(TINY_KNOBS[module])
        kw["user_dir"] = d
    if module == SHADER:
        d = tmp_path / "shaders"
        (d / SHADER).mkdir(parents=True, exist_ok=True)
        (d / SHADER / "1.frag").write_text(EQ_FRAG)
        kw["user_dir"] = d
    return (loader.load(**{**kw, "pipe_values": dict(pipe_values)}),
            jloader.load(**{**kw, "pipe_values": dict(pipe_values)}))


@pytest.mark.parametrize("load_binds", ["values", "defaults"])
@pytest.mark.parametrize("module", PIPE_MODULES)
def test_renderer_pipe_values_match_jax(module, load_binds, tmp_path):
    """``Renderer`` steps with a pipe dict against the JAX step with the
    same dict. The JAX step reads a step's values only in the knobs it
    evaluates inside the pass (bars' COLOR and BAR_OUTLINE, radial's and
    graph's COLOR, shader ``@name`` knobs); its build-time knobs take
    the load's values. ``values``: both loads bind the step's values
    (every knob sees them); ``defaults``: both loads bind the engine's
    defaults, which every module then shares with the JAX package knob
    for knob."""
    pipe = {"fg": np.float32([0.1, 0.9, 0.3, 1.0]),
            "bg": np.float32([0.7, 0.2, 0.5, 1.0])}
    bound = ({k: tuple(float(x) for x in v) for k, v in pipe.items()}
             if load_binds == "values"
             else {k: (0.0, 0.0, 0.0, 0.0) for k in pipe})
    lc, jlc = _module_loads(module, tmp_path, bound)
    r, jr = Renderer(lc, device="cpu"), JaxRenderer(jlc)
    jstep = jr.jit_step(quantize=True)
    jp = {k: jnp.asarray(v) for k, v in pipe.items()}
    rng = np.random.default_rng(4)
    ps, js = r.init_state(), jr.init_state()
    for _ in range(5):
        snap = (rng.standard_normal((2, 1024)) * 0.3).astype(np.float32)
        ps, got = r.step_u8(ps, snap, True, 0.1, 1.0, 0.05, pipe)
        js, want = jstep(js, jnp.asarray(snap), True, np.float32(0.1),
                         np.float32(1.0), np.float32(0.05), jp)
        assert golden_fraction(got.numpy(), want) < 0.002
    drawn = got.numpy()[got.numpy()[..., 3] > 0]
    # circle's one colour is its build-time OUTLINE (@fg): transparent
    # black where the load binds the engine's defaults, in both packages
    assert drawn.size or (module == "circle" and load_binds == "defaults")
    if module in ("bars", "graph", SHADER):
        # COLOR / BASE come from @fg: green dominates what is drawn
        assert drawn[:, :3].mean(axis=0).argmax() == 1


def test_engine_pipe_uniform_changes_color():
    """``fg = #00ff00`` on the pipe stream turns bars green
    (tests/test_runtime.py test_engine_pipe_uniform_changes_color)."""
    frames = []
    eng = Engine(
        EngineOptions(audio_backend="synth", screen=(96, 64), device="cpu",
                      requests=("setprintframes false",),
                      pipe_binds=(stdin_pipe.PipeBind("fg", "vec4"),
                                  stdin_pipe.PipeBind("bg", "vec4"))),
        sink=sinks.CallbackSink(lambda f, t: frames.append(f)),
        pipe_stream=io.StringIO("fg = #00ff00\n"),
    )
    eng.run(max_seconds=2.5)
    last = frames[-1]
    drawn = last[last[..., 3] > 0]
    assert drawn.size > 0
    assert drawn[:, 1].min() == 255
    assert drawn[:, 0].max() == 0


def test_engine_stdin_bind_feeds_a_shader_knob(tmp_path):
    """``--stdin``: bare values on the stream feed the ``STDIN`` bind,
    read by a shader module's ``@STDIN`` knob inside the pass."""
    (tmp_path / "sb").mkdir()
    (tmp_path / "sb" / "1.frag").write_text(EQ_FRAG.replace("@fg:", "@STDIN:"))
    frames = []
    eng = Engine(
        EngineOptions(audio_backend="synth", screen=(96, 64), device="cpu",
                      user_dir=str(tmp_path), force_module="sb",
                      requests=("setprintframes false",),
                      pipe_binds=(stdin_pipe.PipeBind("STDIN", "vec4"),)),
        sink=sinks.CallbackSink(lambda f, t: frames.append(f)),
        pipe_stream=io.StringIO("#00ff00\n"),
    )
    eng.run(max_seconds=2.0)
    drawn = frames[-1][frames[-1][..., 3] > 0]
    assert drawn.size and drawn[:, 0].max() == 0 and drawn[:, 2].max() == 0
    assert drawn[:, 1].max() > 0


def test_engine_keeps_one_pipe_reader_across_reloads():
    eng = Engine(EngineOptions(audio_backend="synth", screen=(48, 32),
                               device="cpu", requests=REQS[1:],
                               pipe_binds=(stdin_pipe.PipeBind("fg", "vec4"),)),
                 sink=sinks.NullSink(), pipe_stream=io.StringIO(""))
    reader = eng.pipe
    eng._build()
    assert eng.pipe is reader


# ---------------------------------------------------------------------------
# the setbgimg wallpaper
# ---------------------------------------------------------------------------

def _wallpaper(tmp_path):
    wall = np.zeros((48, 64, 4), np.uint8)
    wall[..., 0] = np.arange(64, dtype=np.uint8)[None, :] * 3
    wall[..., 1] = np.arange(48, dtype=np.uint8)[:, None] * 5
    wall[..., 2] = 90
    wall[..., 3] = 255
    wp = tmp_path / "wall.png"
    sinks.write_png(wp, wall[::-1])  # writer flips; store top-down `wall`
    return wall, wp


def _xroot_loads(wp, module="bars"):
    reqs = ("setgeometry 8 6 32 16", "setbufsize 1024", "setsamplesize 256",
            "setprintframes false", 'setopacity "xroot"', f'setbgimg "{wp}"')
    return (loader.load(cli_requests=reqs, force_module=module),
            jloader.load(cli_requests=reqs, force_module=module))


def test_load_bg_planes_bit_equal_to_jax(tmp_path):
    _, wp = _wallpaper(tmp_path)
    lc, jlc = _xroot_loads(wp)
    r, jr = Renderer(lc, device="cpu"), JaxRenderer(jlc)
    assert r.bg_path == jr.bg_path == str(wp)
    for a, b in zip(r.load_bg_planes(), jr.load_bg_planes()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("module", ["bars", "graph"])
def test_xroot_wallpaper_frame_matches_jax(module, tmp_path):
    wall, wp = _wallpaper(tmp_path)
    lc, jlc = _xroot_loads(wp, module)
    r, jr = Renderer(lc, device="cpu"), JaxRenderer(jlc)
    jstep = jr.jit_step(quantize=True)
    rng = np.random.default_rng(6)
    ps, js = r.init_state(), jr.init_state()
    for k in range(4):
        snap = (rng.standard_normal((2, 1024)) * 0.3 * (k > 0)).astype(np.float32)
        ps, got = r.step_u8(ps, snap, True, 0.0, 1.0, 0.05)
        js, want = jstep(js, jnp.asarray(snap), True, np.float32(0.0),
                         np.float32(1.0), np.float32(0.05), {})
        assert golden_fraction(got.numpy(), want) < 0.002
        if k == 0:   # silence: the wallpaper at the window geometry
            top = got.numpy()[::-1]
            assert np.abs(top.astype(int) - wall[6:22, 8:40].astype(int)).max() <= 1


def test_engine_reacts_to_background_change(tmp_path):
    """A wallpaper swapped mid-run reaches the composite
    (tests/test_runtime.py test_engine_reacts_to_background_change)."""
    def solid(r, g, b):
        w = np.zeros((48, 64, 4), np.uint8)
        w[..., 0], w[..., 1], w[..., 2], w[..., 3] = r, g, b, 255
        return w

    wp = tmp_path / "wall.png"
    sinks.write_png(wp, solid(255, 0, 0))
    frames = []

    def on_frame(f, t):
        frames.append(f)
        if len(frames) == 5:
            sinks.write_png(wp, solid(0, 0, 255))

    eng = Engine(EngineOptions(audio_backend="synth", screen=(64, 48),
                               device="cpu", inflight=0,
                               requests=("setprintframes false",
                                         'setopacity "xroot"',
                                         f'setbgimg "{wp}"')),
                 sink=sinks.CallbackSink(on_frame))
    eng.run(max_frames=30)
    assert len(frames) >= 30

    def bg_color(frame):
        px = frame[..., :3].reshape(-1, 3)
        colors, counts = np.unique(px, axis=0, return_counts=True)
        return tuple(colors[counts.argmax()])

    assert bg_color(frames[1]) == (255, 0, 0)
    assert bg_color(frames[-1]) == (0, 0, 255)


def test_engine_resize_rebuilds_wallpaper(tmp_path):
    _, wp = _wallpaper(tmp_path)
    frames = []
    eng = Engine(EngineOptions(audio_backend="synth", screen=(64, 48),
                               device="cpu", inflight=2,
                               requests=("setprintframes false",
                                         'setopacity "xroot"',
                                         f'setbgimg "{wp}"')),
                 sink=sinks.CallbackSink(lambda f, t: frames.append(f)))

    def resize(f, t):
        frames.append(f)
        if len(frames) == 3:
            eng.sizereq(32, 24)

    eng.sink = sinks.CallbackSink(resize)
    eng.run(max_frames=10)
    assert len(frames) == 10
    assert {f.shape for f in frames} == {(48, 64, 4), (24, 32, 4)}
    assert eng._bg_dev.shape == (4, 24, 32)


# ---------------------------------------------------------------------------
# the embedding API
# ---------------------------------------------------------------------------

def test_api_entry_wait_tex_sizereq_reload_terminate():
    h = api.entry(["--device", "cpu", "-a", "synth", "--size", "64x48",
                   "-r", "setprintframes false"])
    try:
        api.wait(h, timeout=60)
        f = api.tex(h)
        assert f.shape == (48, 64, 4) and f.dtype == np.uint8
        api.sizereq(h, 0, 0, 32, 24)
        deadline = time.monotonic() + 30
        while api.tex(h).shape != (24, 32, 4) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert api.tex(h).shape == (24, 32, 4)
        first = h.engine.loaded
        api.reload(h)
        deadline = time.monotonic() + 30
        while h.engine.loaded is first and time.monotonic() < deadline:
            time.sleep(0.02)
        assert h.engine.loaded is not first and h.alive
    finally:
        api.terminate(h)
    assert not h.alive and h.error is None
    assert h.engine.opts.device == "cpu"


def test_terminate_during_reload_is_not_lost():
    """A terminate that lands while a reload rebuilds stops the engine
    (the loop's restart must not undo it)."""
    eng = Engine(EngineOptions(audio_backend="synth", screen=(32, 24),
                               device="cpu", requests=REQS[1:]))
    frames = []

    def on_frame(f, t):
        frames.append(f)
        if len(frames) == 2:
            eng.reload()

    rebuild = eng._build

    def build():
        rebuild()
        eng.terminate()

    eng.sink = sinks.CallbackSink(on_frame)
    eng._build = build
    th = threading.Thread(target=eng.run, daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and len(frames) >= 2
    n, eng.frames_rendered = len(frames), 0
    eng.run(max_frames=3)   # a later run starts afresh
    assert len(frames) == n + 3


def test_api_abort_and_return_hooks(monkeypatch):
    seen = []
    monkeypatch.setattr(api, "abort_hook", seen.append)
    monkeypatch.setattr(api, "return_hook", lambda: seen.append("returned"))
    h = api.entry(["--device", "cpu", "-a", "synth", "--size", "32x24"])
    h.engine.sink = sinks.CallbackSink(lambda f, t: 1 / 0)   # a failing engine
    h.thread.join(timeout=60)
    assert not h.alive
    assert isinstance(h.error, ZeroDivisionError) and seen == [h.error]
    h = api.entry(["--device", "cpu", "-a", "synth", "--size", "32x24"])
    api.wait(h, timeout=60)
    api.terminate(h)
    assert seen[-1] == "returned"


# ---------------------------------------------------------------------------
# capture backends and the native ring
# ---------------------------------------------------------------------------

def _fifo_writer(path, seconds=1.5, rate=22050):
    def run():
        t = np.arange(int(rate * seconds)) / rate
        s = (np.sin(2 * np.pi * 440 * t) * 20000).astype("<i2")
        inter = np.empty(2 * len(s), dtype="<i2")
        inter[0::2] = s
        inter[1::2] = -s
        try:
            with open(path, "wb") as f:
                for i in range(0, len(inter), 1024):
                    f.write(inter[i:i + 1024].tobytes())
                    f.flush()
                    time.sleep(1024 / 2 / rate)
        except BrokenPipeError:
            pass   # the reader stopped first

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


@pytest.mark.parametrize("native_ring", [True, False])
def test_fifo_backend_through_mkfifo(native_ring, tmp_path):
    """s16le stereo through a real FIFO lands in the ring scaled by
    1/65535 (fifo.c:99-106), by the native reader or the Python one."""
    if native_ring and not native.available():
        pytest.skip(f"no C++ toolchain: {native.build_error()}")
    path = str(tmp_path / "mpd.fifo")
    os.mkfifo(path)
    audio = audio_mod.make_audio_data(2048, 1024, 22050, 2, source=path,
                                      prefer_native=native_ring)
    assert isinstance(audio, audio_mod.NativeAudioData) == native_ring
    backend = audio_mod.lookup("fifo")
    backend.init(audio)
    th = backend.spawn(audio)
    w = _fifo_writer(path)
    try:
        time.sleep(0.8)
        buf, mod = audio.snapshot()
        assert mod and th.error is None
        assert 0.25 < np.abs(buf).max() < 0.35
        np.testing.assert_allclose(buf[1, -256:], -buf[0, -256:], atol=1e-6)
    finally:
        audio.terminate = True
        th.join(timeout=5)
        w.join(timeout=5)


def test_engine_renders_from_fifo(tmp_path):
    path = str(tmp_path / "mpd.fifo")
    os.mkfifo(path)
    frames = []
    eng = Engine(EngineOptions(audio_backend="fifo", screen=(64, 48),
                               device="cpu",
                               requests=REQS[1:] + (f'setsource "{path}"',)),
                 sink=sinks.CallbackSink(lambda f, t: frames.append(f)))
    w = _fifo_writer(path)
    eng.run(max_seconds=1.2)
    w.join(timeout=5)
    assert eng.updates > 0 and len(frames) > 3
    assert (frames[-1][..., 3] > 0).any()


def test_engine_fifo_missing_path_fails_fast(tmp_path):
    eng = Engine(EngineOptions(
        audio_backend="fifo", screen=(32, 32), device="cpu",
        requests=REQS[1:] + (f'setsource "{tmp_path}/does_not_exist"',)))
    with pytest.raises(RuntimeError, match="audio backend failed|FIFO"):
        eng.run(max_seconds=5.0)


class _FakeLibpulse:
    """The 4 libpulse-simple entry points the binding uses: deterministic
    interleaved fragments, capture ended after 3 reads
    (tests/test_runtime.py's fake)."""

    def __init__(self, audio):
        self.audio = audio
        self.new_args = None
        self.reads = 0
        self.freed = False

    def pa_simple_new(self, server, app, direction, source, desc,
                      ss_ref, chmap, pb_ref, err_ref):
        self.new_args = dict(
            app=app, direction=direction, source=source,
            ss=(ss_ref._obj.format, ss_ref._obj.rate, ss_ref._obj.channels),
            fragsize=pb_ref._obj.fragsize, maxlength=pb_ref._obj.maxlength,
        )
        return 1

    def pa_simple_read(self, handle, buf, nbytes, err_ref):
        import ctypes

        n = int(getattr(nbytes, "value", nbytes))
        frames = n // 8
        base = self.reads * frames
        inter = np.empty((2 * frames,), np.float32)
        inter[0::2] = 0.001 * (base + np.arange(frames))
        inter[1::2] = -0.001 * (base + np.arange(frames))
        ctypes.memmove(buf, inter.tobytes(), n)
        self.reads += 1
        if self.reads >= 3:
            self.audio.terminate = True
        return 0

    def pa_simple_free(self, handle):
        self.freed = True

    def pa_strerror(self, code):
        return b"fake error"


@pytest.mark.parametrize("channels", [2, 1])
def test_pulse_native_fake_libpulse(channels):
    """The ctypes pa_simple path configures the stream as
    pulse_input.c:114-123 and de-interleaves fragments into the ring
    (mono: both channels mixed into each)."""
    from glava_tpu_torch.runtime.audio import pa_simple as pas
    from glava_tpu_torch.runtime.audio.pulse import PulseBackend

    audio = audio_mod.AudioData(buffer=np.zeros((2, 64), np.float32),
                                sample_sz=32, rate=22050, channels=channels,
                                source="fake.monitor")
    fake = _FakeLibpulse(audio)
    b = PulseBackend()
    b.libpulse = fake
    b._entry_native(audio)
    assert fake.new_args["direction"] == pas.PA_STREAM_RECORD
    assert fake.new_args["source"] == b"fake.monitor"
    assert fake.new_args["fragsize"] == 32
    assert fake.new_args["maxlength"] == 0xFFFFFFFF
    assert fake.new_args["ss"] == (pas.FSAMPLE_FORMAT, 22050, 2)
    assert fake.reads == 3 and fake.freed
    snap, mod = audio.snapshot()
    assert mod
    hop = audio.hop
    want = 0.001 * np.arange(3 * hop, dtype=np.float32)
    if channels == 2:
        np.testing.assert_allclose(snap[0, -3 * hop:], want, atol=1e-7)
        np.testing.assert_allclose(snap[1, -3 * hop:], -want, atol=1e-7)
    else:
        np.testing.assert_allclose(snap, 0.0, atol=1e-7)
    assert (snap[:, :-3 * hop] == 0).all()


def test_pulse_missing_everything_fails_clearly(monkeypatch):
    import shutil as _shutil

    from glava_tpu_torch.runtime.audio import pa_simple as pas
    from glava_tpu_torch.runtime.audio.pulse import PulseBackend

    monkeypatch.setattr(_shutil, "which", lambda *_: None)
    monkeypatch.setattr(pas, "load_libpulse", lambda: None)
    audio = audio_mod.AudioData(buffer=np.zeros((2, 64), np.float32),
                                sample_sz=32, rate=22050, channels=2,
                                source="x.monitor")
    with pytest.raises(RuntimeError, match="libpulse-simple or `parec`"):
        PulseBackend().init(audio)


def test_default_backend_is_pulseaudio():
    from glava_tpu.runtime.engine import EngineOptions as JaxOptions

    assert EngineOptions().audio_backend == JaxOptions().audio_backend \
        == "pulseaudio"
    assert {"fifo", "pulseaudio", "synth", "wav"} <= set(audio_mod.available())


@pytest.mark.parametrize("mono", [False, True])
def test_native_ring_matches_python_ring(mono):
    if not native.available():
        pytest.skip(f"no C++ toolchain: {native.build_error()}")
    ch = 1 if mono else 2
    nat = audio_mod.make_audio_data(512, 256, 22050, ch)
    py = audio_mod.make_audio_data(512, 256, 22050, ch, prefer_native=False)
    assert isinstance(nat, audio_mod.NativeAudioData)
    assert type(py) is audio_mod.AudioData
    rng = np.random.default_rng(9)
    assert nat.snapshot()[1] == py.snapshot()[1] is False
    for k in range(12):
        n = (64, 100, 300, 512)[k % 4]
        left = rng.standard_normal(n).astype(np.float32)
        right = rng.standard_normal(n).astype(np.float32)
        for a in (nat, py):
            a.push(left, right)
        if k % 3 == 2:
            (bn, mn), (bp, mp) = nat.snapshot(), py.snapshot()
            assert mn == mp is True
            assert np.array_equal(bn, bp)


def test_native_builds_under_build_dir():
    if not native.available():
        pytest.skip(f"no C++ toolchain: {native.build_error()}")
    lib = native._target()
    assert lib.is_file() and lib.parent == native.ROOT / "build" / "glava_tpu_torch"
    assert native.SOURCE == native.ROOT / "glava_tpu" / "native" / "ring.cpp"

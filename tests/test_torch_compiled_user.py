"""The compiled step of user Python modules (``compiled.user_pass``)
against the eager step and the JAX package's jitted step.

On the CPU a compiled step runs its static-buffer body eagerly, a user
module's passes under the guard a card's warm-up and capture run them
under. Each case feeds the same seeded numpy inputs:

* ``glava_tpu_torch/examples/vu_meter.py`` (one stream, a fleet of 4, a
  mixed fleet with bars and vu_meter, and the fleet sharded over a 2 x 2
  mesh of CPU devices) through ``jit_step`` over a schedule of both
  branches (``modified`` true and false) and a pipe write every frame:
  byte-equal to the eager step on every frame, one capture a branch;
  one stream's frames against ``jax.jit`` of the JAX package's
  ``docs/examples/vu_meter.py`` under the golden rule (under 0.2% of
  pixels more than 2 LSB apart);
* the same steps with every host read of a tensor and every tensor made
  from host data patched to raise (``tests/test_torch_compiled.py``'s
  sync guard);
* a user module whose pass reads ``inputs.time`` and, batched, an
  ``inputs.pipe`` row (``TIMED``), one stream and a fleet, with both
  changing every frame: byte-equal to the eager step, every frame a new
  one (nothing frozen at the capture), one capture a branch;
* user modules whose pass reads a tensor on the host or makes one from
  host data, each refused with ``compiled.Uncapturable`` naming it (its
  eager step still runs), after which another module's compiled step
  still works; a host constant through ``compiled.const`` passes;
* the Engine and ``render_wav`` running vu_meter on its compiled step.
"""

from __future__ import annotations

import shutil
import wave
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glava_tpu.config import loader as jloader
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu_torch import compiled
from glava_tpu_torch.config import loader
from glava_tpu_torch.parallel import (
    BatchedRenderer, MixedBatchedRenderer, ShardedRenderer, make_mesh,
)
from glava_tpu_torch.renderer import CompiledStep, Renderer
from glava_tpu_torch.runtime import sinks
from glava_tpu_torch.runtime.engine import Engine, EngineOptions
from glava_tpu_torch.runtime.offline import render_wav
from tests.test_torch_compiled import (
    _no_host_data, _no_host_reads, golden_fraction,
)

ROOT = Path(__file__).resolve().parent.parent
PORT_VU = ROOT / "glava_tpu_torch" / "examples" / "vu_meter.py"
JAX_VU = ROOT / "docs" / "examples" / "vu_meter.py"
REQS = ("setgeometry 0 0 64 48", "setbufsize 1024", "setsamplesize 256",
        "setprintframes false")
S = 4
# (modified, time) a frame: both branches, each more than once
SCHEDULE = tuple((m, 0.1 * k) for k, m in enumerate(
    (True, True, False, True, False, False, True, True)))

# a user module template: ``{line}`` is the pass's one extra statement
BAD = '''
import numpy as np
import torch

from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register


@register("{name}", uniforms=(("audio_l", "audio_l",
                               ("window", "fft", "gravity", "avg")),))
def build(ctx):
    w, h = ctx.screen
    # the build function runs once, at load: host data is welcome here
    ramp = torch.as_tensor(np.linspace(0.0, 1.0, w, dtype=np.float32),
                           device=ctx.device)

    def pass1(inputs):
        level = torch.mean(inputs.textures["audio_l"])
        {line}
        a = (ramp < level).to(torch.float32).expand(h, w)
        return (a, a * 0.5, a * 0.25, a)

    return base.ModuleBuild("{name}", [pass1])
'''
REFUSED = {
    "item": ("level = level + level.item()", r"Tensor\.item"),
    "bool": ("level = level * 2.0 if level > 0.01 else level",
             r"Tensor\.__bool__"),
    "float": ("level = level + float(level)", r"Tensor\.__float__"),
    "tolist": ("level = level + sum([level.tolist()])", r"Tensor\.tolist"),
    "numpy": ("level = level + level.numpy()", r"Tensor\.numpy"),
    "cpu": ("level = level.cpu()", r"Tensor\.cpu"),
    "to_cpu": ("level = level.to('cpu')", r"Tensor\.to"),
    "print": ("print(level)", r"Tensor\.__repr__"),
    "as_tensor": ("level = level + torch.as_tensor(np.float32(0.5))",
                  r"torch\.as_tensor"),
    "tensor": ("level = level + torch.tensor(0.5)", r"torch\.tensor"),
    "from_numpy": ("level = level + torch.from_numpy(np.ones(1, np.float32))",
                   r"torch\.from_numpy"),
}


# a user module whose pass reads the per-frame time and, when it takes a
# stream axis (``{batched}``), each stream's ``fg`` pipe row
TIMED = '''
import torch

from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register


@register("timed", uniforms=(("audio_l", "audio_l",
                              ("window", "fft", "gravity", "avg")),))
def build(ctx):
    w, h = ctx.screen
    ramp = torch.linspace(0.0, 1.0, w, device=ctx.device)

    def pass1(inputs):
        level = torch.mean(inputs.textures["audio_l"], dim=-1, keepdim=True)
        t = base.f32_tensor(inputs.time, ramp.device).reshape(-1, 1)
        wave = 0.5 + 0.5 * torch.sin(ramp * 6.0 + 3.0 * t)
        gain = (base.f32_tensor(inputs.pipe["fg"], ramp.device)[:, :1]
                if inputs.pipe else torch.ones_like(t))
        planes = ((ramp < level * 40.0).to(torch.float32) * wave, wave,
                  wave * gain, torch.ones_like(wave))
        if {batched}:
            return tuple(p[:, None, :].expand(-1, h, w) for p in planes)
        return tuple(p.expand(h, w) for p in planes)

    return base.ModuleBuild("timed", [pass1], batched={batched})
'''


def _root(d: Path, module: Path = PORT_VU, name: str = "vu_meter") -> Path:
    (d / "modules").mkdir(parents=True, exist_ok=True)
    shutil.copy(module, d / "modules" / f"{name}.py")
    (d / "vu_meter.glsl").write_text("#define METER_COLOR #ff00ff\n")
    return d


def _bad_root(d: Path, line: str, name: str = "bad") -> Path:
    (d / "modules").mkdir(parents=True, exist_ok=True)
    (d / "modules" / f"{name}.py").write_text(BAD.format(name=name,
                                                         line=line))
    return d


def _vu(tmp_path: Path, reqs=REQS):
    return loader.load(cli_requests=reqs, force_module="vu_meter",
                       user_dir=_root(tmp_path / "vu"))


def _snaps(n: int, seed: int = 3) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 1024)) * 0.3).astype(np.float32)
            for _ in range(n)]


def _fleet(k: int, rng):
    """The k-th fleet step's inputs: audio, a staggered mask, time,
    interp, gravity, and an ``fg`` row a stream, written every frame."""
    audio = (rng.standard_normal((S, 2, 1024)) * 0.3).astype(np.float32)
    modified = np.array([k % (s + 1) == 0 for s in range(S)])
    g = rng.uniform(0.02, 0.08, S).astype(np.float32)
    fg = np.stack([np.float32([0.1 + 0.1 * k, 0.9, 0.3 + 0.05 * s, 1.0])
                   for s in range(S)])
    return (audio, modified, np.full(S, 0.1 * k, np.float32),
            np.ones(S, np.float32), g, {"fg": fg})


def _fleet_renderer(kind: str, tmp_path: Path):
    vu = _vu(tmp_path)
    if kind == "fleet":
        return BatchedRenderer(vu, S, device="cpu")
    if kind == "mixed fleet":
        bars = loader.load(cli_requests=REQS, force_module="bars",
                           pipe_values={"fg": (0.1, 0.9, 0.3, 1.0)})
        return MixedBatchedRenderer([bars, vu], [0, 1, 1, 0], device="cpu")
    return ShardedRenderer([vu], [0] * S, make_mesh(["cpu"] * 4, rows=2))


def _equal(got, want) -> bool:
    if isinstance(got, list):
        return all(torch.equal(g, w) for g, w in zip(got, want))
    return torch.equal(got, want)


def _captures(step) -> int:
    steps = step.steps if hasattr(step, "steps") else [step]
    return sum(s.step.captures for s in steps)


# -- (a) byte-equal to the eager step ------------------------------------------

def test_vu_meter_one_stream_compiled_step_equals_eager_and_jax(tmp_path):
    """One stream over both branches and a pipe write every frame: the
    compiled step byte-equal to the eager step, one capture a branch,
    and within the golden rule of JAX's jitted step of the JAX
    vu_meter."""
    lc = _vu(tmp_path)
    jlc = jloader.load(cli_requests=REQS, force_module="vu_meter",
                       user_dir=_root(tmp_path / "jax", JAX_VU))
    r, jr = Renderer(lc, device="cpu"), JaxRenderer(jlc)
    assert r.module.kind == "python"
    step, jstep = r.jit_step(quantize=True), jr.jit_step(quantize=True)
    assert isinstance(step, CompiledStep)
    cs, es, js = r.init_state(), r.init_state(), jr.init_state()
    for k, (snap, (mod, t)) in enumerate(zip(_snaps(len(SCHEDULE)),
                                             SCHEDULE)):
        pipe = {"fg": np.float32([0.1 + 0.1 * k, 0.9, 0.3, 1.0])}
        cs, got = step(cs, snap, mod, t, 0.5, 0.05, pipe)
        es, want = r.step_u8(es, snap, mod, t, 0.5, 0.05, pipe)
        assert torch.equal(got, want), f"frame {k}"
        js, jwant = jstep(js, jnp.asarray(snap), mod, np.float32(t),
                          np.float32(0.5), np.float32(0.05), {})
        assert golden_fraction(got.numpy(), np.asarray(jwant)) < 0.002
    assert (got.numpy()[..., 3] > 0).any()
    assert step.step.captures == 2


@pytest.mark.parametrize("kind", ["fleet", "mixed fleet", "sharded fleet"])
def test_vu_meter_fleet_compiled_step_equals_eager(kind, tmp_path):
    """A fleet of 4, a mixed fleet (bars and vu_meter) and the fleet on
    a 2 x 2 mesh of CPU devices: 6 staggered steps, a pipe write every
    frame, byte-equal to the eager fleet step, one capture a device."""
    br = _fleet_renderer(kind, tmp_path)
    step = br.jit_step(quantize=True)
    cs, es = br.init_state(), br.init_state()
    rng = np.random.default_rng(7)
    for k in range(6):
        *args, pipe = _fleet(k, rng)
        cs, got = step(cs, *args, pipe)
        es, want = br.step(es, *args, pipe, quantize=True)
        assert _equal(got, want), f"{kind} step {k}"
    assert _captures(step) == (4 if kind == "sharded fleet" else 1)
    frames = torch.cat([torch.cat(got[2 * i:2 * i + 2], dim=1)
                        for i in range(2)]) if isinstance(got, list) else got
    assert (frames[..., 3] > 0).any()


@pytest.mark.parametrize("batched", [False, True],
                         ids=["unbatched", "batched"])
@pytest.mark.parametrize("kind", ["one stream", "fleet"])
def test_a_user_pass_reads_time_and_pipe_every_frame(kind, batched,
                                                     tmp_path):
    """``TIMED``'s compiled step, the time and (batched) its ``fg`` pipe
    row changing every frame: byte-equal to the eager step, no two
    frames alike (neither value frozen at the capture), one capture a
    branch."""
    (tmp_path / "modules").mkdir()
    (tmp_path / "modules" / "timed.py").write_text(
        TIMED.format(batched=batched))
    lc = loader.load(cli_requests=REQS, force_module="timed",
                     user_dir=tmp_path)
    frames = []
    if kind == "one stream":
        r = Renderer(lc, device="cpu")
        assert r.module.batched is batched
        step = r.jit_step(quantize=True)
        cs, es = r.init_state(), r.init_state()
        for k, (snap, (mod, t)) in enumerate(zip(_snaps(len(SCHEDULE)),
                                                 SCHEDULE)):
            pipe = {"fg": np.float32([0.9 - 0.1 * k, 0.5, 0.3, 1.0])}
            cs, got = step(cs, snap, mod, t, 0.5, 0.05, pipe)
            es, want = r.step_u8(es, snap, mod, t, 0.5, 0.05, pipe)
            assert torch.equal(got, want), f"frame {k}"
            frames.append(got.clone())
        assert step.step.captures == 2
    else:
        br = BatchedRenderer(lc, S, device="cpu")
        step = br.jit_step(quantize=True)
        cs, es = br.init_state(), br.init_state()
        rng = np.random.default_rng(5)
        for k in range(6):
            *args, pipe = _fleet(k, rng)
            cs, got = step(cs, *args, pipe)
            es, want = br.step(es, *args, pipe, quantize=True)
            assert torch.equal(got, want), f"step {k}"
            frames.append(got.clone())
        assert step.step.captures == 1
    assert all(not torch.equal(a, b) for i, a in enumerate(frames)
               for b in frames[:i])
    if batched:
        # the blue plane is the green one times the fg row's red
        g, b = (frames[-1][..., c].to(torch.int32) for c in (1, 2))
        assert (b <= g).all() and (b < g).any()


# -- (b) no host reads ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["one stream", "fleet"])
def test_vu_meter_compiled_step_reads_nothing_on_the_host(kind, tmp_path):
    """After warm-up, vu_meter's compiled steps with every host read of
    a tensor and every tensor made from host data patched to raise."""
    if kind == "one stream":
        r = Renderer(_vu(tmp_path), device="cpu")
        step, st = r.jit_step(quantize=True), r.init_state()
        snaps = _snaps(4)
        for mod in (True, False):
            st, _ = step(st, snaps[0], mod, 0.1, 0.5, 0.05)
        step._body = _no_host_data(step._body)
        with _no_host_reads():
            for k, snap in enumerate(snaps[1:]):
                st, frame = step(st, snap, k != 1, 0.2 * k, 0.5, 0.05)
        assert frame.shape == (48, 64, 4)
        return
    br = _fleet_renderer("fleet", tmp_path)
    step, st = br.jit_step(quantize=True), br.init_state()
    rng = np.random.default_rng(1)
    st, _ = step(st, *_fleet(0, rng))
    step._body = _no_host_data(step._body)
    with _no_host_reads():
        for k in range(1, 4):
            st, frames = step(st, *_fleet(k, rng))
    assert frames.shape == (S, 48, 64, 4)


# -- (c) a host-reading user module is refused by name ----------------------------

@pytest.mark.parametrize("what", sorted(REFUSED))
def test_a_host_reading_user_module_is_refused_by_name(what, tmp_path):
    """A pass that reads a tensor on the host or makes one from host
    data raises ``compiled.Uncapturable`` naming its module, one stream
    and in a fleet beside bars; its eager step still runs; bars' compiled
    step works after the refusal."""
    line, pattern = REFUSED[what]
    lc = loader.load(cli_requests=REQS, force_module="bad",
                     user_dir=_bad_root(tmp_path / "bad", line))
    r = Renderer(lc, device="cpu")
    snap = _snaps(1)[0]
    r.step_u8(r.init_state(), snap, True, 0.0, 1.0, 0.05)
    step = r.jit_step(quantize=True)
    with pytest.raises(compiled.Uncapturable,
                       match=rf"module 'bad' has no compiled step: .*{pattern}"):
        step(r.init_state(), snap, True, 0.0, 1.0, 0.05)
    bars = loader.load(cli_requests=REQS, force_module="bars")
    mixed = MixedBatchedRenderer([bars, lc], [0, 1, 0, 1], device="cpu")
    *args, pipe = _fleet(0, np.random.default_rng(2))
    with pytest.raises(compiled.Uncapturable, match=r"module 'bad' has no"):
        mixed.jit_step()(mixed.init_state(), *args)
    assert torch.from_numpy is compiled._FROM_NUMPY["fn"]
    rb = Renderer(bars, device="cpu")
    _, got = rb.jit_step(quantize=True)(rb.init_state(), snap, True, 0.0,
                                         1.0, 0.05)
    _, want = rb.step_u8(rb.init_state(), snap, True, 0.0, 1.0, 0.05)
    assert torch.equal(got, want)


def test_a_user_module_uploads_a_host_constant_once(tmp_path):
    """A host value a pass hands to ``compiled.const`` is uploaded in
    the warm-up and reused: the compiled step equals the eager one."""
    line = ("from glava_tpu_torch import compiled\n        level = level + "
            "compiled.const(np.float32([0.25]), level.device)[0]")
    lc = loader.load(cli_requests=REQS, force_module="bad",
                     user_dir=_bad_root(tmp_path / "c", line))
    r = Renderer(lc, device="cpu")
    step = r.jit_step(quantize=True)
    cs, es = r.init_state(), r.init_state()
    for k, snap in enumerate(_snaps(3)):
        cs, got = step(cs, snap, True, 0.1 * k, 1.0, 0.05)
        es, want = r.step_u8(es, snap, True, 0.1 * k, 1.0, 0.05)
        assert torch.equal(got, want)
    assert len(step.step._consts) == 1


# -- (d) the Engine and render_wav -------------------------------------------------

def test_engine_and_render_wav_run_vu_meter_compiled(tmp_path, capsys):
    """The Engine's step and ``render_wav``'s for vu_meter are its
    compiled step (a capture a branch, nothing said on stderr)."""
    root = _root(tmp_path / "vu")
    eng = Engine(EngineOptions(audio_backend="synth", screen=(64, 48),
                               device="cpu", force_module="vu_meter",
                               user_dir=str(root),
                               requests=("setprintframes false",)),
                 sink=sinks.NullSink())
    assert isinstance(eng._step, CompiledStep)
    eng.run(max_frames=3)
    assert eng.frames_rendered == 3 and eng._step.step.captures >= 1
    wav = tmp_path / "tone.wav"
    t = np.arange(11025) / 22050.0
    pcm = (0.4 * np.sin(2 * np.pi * 440.0 * t) * 32767).astype(np.int16)
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(pcm.tobytes())
    captured = []
    run = compiled.Step.run

    def watched(self, branch, body):
        out = run(self, branch, body)
        captured.append((self.name, self.captures))
        return out

    lc = loader.load(cli_requests=("setprintframes false",),
                     force_module="vu_meter", user_dir=str(root))
    sink = sinks.NullSink()
    compiled.Step.run = watched
    try:
        n = render_wav(lc, str(wav), sink, fps=30.0, screen=(64, 48),
                       device="cpu")
    finally:
        compiled.Step.run = run
    assert n > 0 and len(captured) == n
    assert {name for name, _ in captured} == {"vu_meter"}
    assert "eager" not in capsys.readouterr().err

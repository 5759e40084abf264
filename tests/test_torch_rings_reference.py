"""The user GLSL module ``rings`` (docs/examples/rings) through the port's
``Engine`` path against the benchmark's plain reference
(``benchmark/reference/rings.py``), judged by the benchmark's pixel rule
(``benchmark/benchlib/check.py``: no stable pixel more than 2 LSB off,
a pixel stable when the reference draws it alike from its texture
shifted by +-``BAND_SCALE`` times the spectrum limit).

The port renders through its compiled step's CPU branch, fed seeded PCM
as the benchmark makes it; the reference draws from the texture the
port's own spectrum state gives. Planted faults in the shader, each of
which the rule must catch: the smear pass dropped, REPEAT replaced by a
clamp at column 0, the dither hash's shift changed, the rotation matrix
transposed, ``pos`` read from ``atan(x, y)``; and the reference itself
drawn in float16 or bfloat16. Also: the reference loads nothing of the
port, every interpreted pass records a ``shader.pass`` span inside its
step's span, and on a card a captured rings branch's ``step.replay``
payload is the kernels a replay launches, and a graph that holds a loop
carries no count."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from benchlib import check, pcm as pcm_mod  # noqa: E402
from reference import rings  # noqa: E402

from glava_tpu_torch.runtime.engine import Engine, EngineOptions  # noqa: E402
from glava_tpu_torch.utils import profiling  # noqa: E402

EXAMPLES = ROOT / "docs" / "examples"
RATE, BUFSIZE, HOP = 22050, 4096, 256
SEEDS = [3, 2**31 + 77, 4_100_000_017]
WIDE, TALL = (192, 108), (64, 128)
# the shader text a fault replaces (file, old, new); None drops the file
FAULTS = {
    "smear_dropped": ("2.frag", None, None),
    "repeat_as_clamp": ("2.frag", "vec2(uv.x - 1.0 / float(screen.x), uv.y)",
                        "vec2(max(uv.x - 1.0 / float(screen.x), 0.0), uv.y)"),
    "dither_shift": ("1.frag", "(hx << 3)", "(hx << 2)"),
    "rotation_transposed": ("1.frag", "mat2(0.8, -0.6, 0.6, 0.8)",
                            "mat2(0.8, 0.6, -0.6, 0.8)"),
    "atan_swapped": ("1.frag", "atan(p.y, p.x)", "atan(p.x, p.y)"),
}


def _engine(user_dir, geometry, device="cpu") -> Engine:
    w, h = geometry
    return Engine(EngineOptions(
        entry="rc.glsl", user_dir=str(user_dir), force_module="rings",
        requests=(f"setgeometry 0 0 {w} {h}", "setprintframes false"),
        audio_backend="synth", device=device))


def _snapshots(seed: int, frames: int) -> list:
    """Ring snapshots of the benchmark's seeded PCM of stream 0, after
    4, 7, 10, ... pushes of a hop."""
    pushes = [4 + 3 * k for k in range(frames)]
    pcm = pcm_mod.make_pcm(seed, 1, pushes[-1] * HOP, RATE)[0]
    out = []
    for n in pushes:
        end = n * HOP
        snap = np.zeros((2, BUFSIZE), np.float32)
        got = pcm[:, max(0, end - BUFSIZE):end]
        snap[:, BUFSIZE - got.shape[1]:] = got
        out.append(snap)
    return out


def _port_frames(eng: Engine, seed: int, frames: int = 4) -> list:
    """(frame, texture) a step: the Engine's compiled step on fresh audio
    every frame, and the (1, sz) texture its spectrum state gives."""
    out = []
    for k, snap in enumerate(_snapshots(seed, frames)):
        eng.state, frame = eng._step(eng.state, snap, True, 0.1 * k, 1.0,
                                     0.05, {})
        zero = torch.zeros(BUFSIZE, device=eng.renderer.device)
        tex = eng.renderer.pipeline.textures_from(eng.state.chains, zero,
                                                  zero)["audio_l"]
        # the frame is the step's static buffer: the next step rewrites it
        out.append((frame.cpu().numpy().copy(), tex[None].clone()))
    return out


def _px_off(ref: rings.Module, frames: list) -> tuple:
    """(px_off over the frames, lit pixels of the reference's frames)."""
    band = check.BAND_SCALE * check.LIMITS["spec_err"]
    off = lit = 0
    for got, tex in frames:
        want = ref.render({"audio_l": tex}, None, None)[0]
        stable = torch.stack([
            (ref.render({"audio_l": torch.clamp(tex + b, 0.0, 1.0)}, None,
                        None)[0] == want).all(dim=-1)
            for b in (band, -band)]).all(dim=0).cpu().numpy()
        want = want.cpu().numpy()
        off += check._px_off(got, want, stable)
        lit += int((want[..., 3] > 0).sum())
    return off, lit


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("geometry", [WIDE, TALL], ids=["192x108", "64x128"])
def test_port_draws_what_the_reference_draws(geometry, seed):
    eng = _engine(EXAMPLES, geometry)
    assert eng.renderer.module.kind == "shader"
    ref = rings.Module({}, *geometry, eng.renderer.pipeline.sz, "cpu")
    off, lit = _px_off(ref, _port_frames(eng, seed))
    assert lit > 100, "the ring drew too little to judge"
    assert off == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_caught(fault, tmp_path):
    """The shader with the fault through the port, at the tall geometry
    (the ring crosses columns 0 and 1 there, so the wrap shows), judged
    against the reference of the shader as it is."""
    mod = tmp_path / "rings"
    shutil.copytree(EXAMPLES / "rings", mod)
    name, old, new = FAULTS[fault]
    if old is None:
        (mod / name).unlink()
    else:
        text = (mod / name).read_text()
        assert old in text
        (mod / name).write_text(text.replace(old, new))
    eng = _engine(tmp_path, TALL)
    ref = rings.Module({}, *TALL, eng.renderer.pipeline.sz, "cpu")
    off, _ = _px_off(ref, _port_frames(eng, SEEDS[1], frames=3))
    assert off > 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=["float16", "bfloat16"])
def test_a_raster_in_lower_precision_is_caught(dtype):
    """The reference drawn in a precision below GLSL's float, from the
    port's own textures, judged by the rule against itself in float32:
    the rule fails a raster computed in float16 or bfloat16 (at the tall
    geometry: the ring's radius is larger there, so float16's spacing
    at it is too)."""
    eng = _engine(EXAMPLES, TALL)
    sz = eng.renderer.pipeline.sz
    low = rings.Module({}, *TALL, sz, "cpu", dtype=dtype)
    frames = [(low.render({"audio_l": tex}, None, None)[0].numpy(), tex)
              for _, tex in _port_frames(eng, SEEDS[1], frames=3)]
    off, _ = _px_off(rings.Module({}, *TALL, sz, "cpu"), frames)
    assert off > 0


def test_reference_loads_nothing_of_the_port():
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\n"
            "from reference import rings, module\n"
            "assert module('rings') is rings\n"
            "import json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "glava_tpu",
                       "glava_tpu_torch"}


def _by_frame(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.frame, {}).setdefault(s.kind, []).append(s)
    return out


def test_each_pass_records_a_shader_pass_span(monkeypatch):
    """Each frame's step records one ``shader.pass`` span a pass (two),
    inside its ``step.capture`` (the first frame's, the warm-up) or
    ``step.replay`` (the CPU branch's eager run), with payload 0, as
    the CPU's ``step.replay``: the CPU captures no graph."""
    monkeypatch.setattr(profiling, "_store", None)
    monkeypatch.setattr(profiling, "_depth", 0)
    eng = _engine(EXAMPLES, (48, 32))
    snaps = _snapshots(SEEDS[0], 3)
    with profiling.record():
        for k, snap in enumerate(snaps):
            tf = profiling.frame_begin(0, k)
            eng.state, _ = eng._step(eng.state, snap, True, 0.0, 1.0, 0.05,
                                     {})
            profiling.frame_end(0, k, tf)
    frames = _by_frame(profiling.spans())
    assert sorted(frames) == [0, 1, 2]
    for k, kinds in frames.items():
        (step,) = kinds["step"]
        parent = kinds["step.capture" if k == 0 else "step.replay"]
        passes = kinds["shader.pass"]
        assert len(passes) == 2 and len(parent) == 1
        assert all(parent[0].start <= p.start <= p.end <= parent[0].end
                   and step.start <= p.start and p.end <= step.end
                   for p in passes)
        assert [p.payload for p in passes] == [0, 0]
        assert all(s.payload == 0 for s in kinds.get("step.replay", ()))


@pytest.mark.cuda
def test_replay_payload_is_the_kernels_a_replay_launches():
    """On the card, rings at 1080p: each captured branch (fresh audio or
    not) replays as many kernels, in a ``torch.profiler`` trace, as its
    ``step.replay`` span's payload counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    eng = _engine(EXAMPLES, (1920, 1080), device="cuda")
    snaps = _snapshots(SEEDS[2], 3)

    def step(modified: bool) -> None:
        eng.state, _ = eng._step(eng.state, snaps[-1], modified, 0.0, 1.0,
                                 0.05, {})

    for modified in (True, False):
        step(modified)           # warm-up and capture of the branch
    for modified in (True, False):
        step(modified)
        torch.cuda.synchronize()
        with profiling.record():
            step(modified)
        torch.cuda.synchronize()
        (payload,) = [s.payload for s in profiling.spans()
                      if s.kind == "step.replay"]
        assert payload > 0
        assert payload == _device_kernels(lambda: step(modified)), modified


def _device_kernels(fn) -> int:
    """Kernels a ``torch.profiler`` trace of ``fn()`` shows on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "memcpy",
                                          "memset"))
               for e in prof.events())


@pytest.mark.cuda
def test_a_graph_with_a_loop_carries_no_count():
    """A compiled step whose body holds a data-dependent loop (a while
    node) captures and replays as it did, and its graph's count is 0
    (no count: the body's kernels are not walked); the same step
    without the loop counts the kernels a replay launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from glava_tpu_torch import compiled
    from glava_tpu_torch.ops import graph_while

    x = torch.zeros(4, device="cuda")
    trips = torch.full((4,), 2.0, device="cuda")
    act = torch.zeros(16, dtype=torch.bool, device="cuda")
    fuel = torch.zeros(1, dtype=torch.int32, device="cuda")

    def body():
        x.copy_(torch.where(act[:4], x + 1.0, x))
        act[:4].copy_(act[:4] & (x < trips))
        fuel.add_(1)

    def fn(loop: bool):
        x.zero_()
        fuel.zero_()
        act[:4].copy_(x < trips)
        if loop:
            graph_while.run(act, fuel, 100, body)
        else:
            body()
        return x * 2.0

    step = compiled.Step("cuda", {})
    for loop in (True, False):
        for _ in range(3):           # warm-up and capture, then replays
            out = step.run(loop, fn)
        torch.cuda.synchronize()
        assert out.tolist() == [4.0 if loop else 2.0] * 4
        kernels = step._graphs[loop][3]
        if loop:
            assert int(fuel.item()) == 2 and kernels == 0
        else:
            assert kernels > 0
            assert kernels == _device_kernels(lambda: step.run(loop, fn))

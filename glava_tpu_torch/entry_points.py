"""The port's entry points: one step to call, and a dry run of the
multi-device path.

The port of the root ``__graft_entry__.py``. :func:`entry` gives the
single-stream bars step at 512x256 with its example arguments;
:func:`dryrun_multichip` drives the fleet sharded over a mesh of
devices (``parallel.mesh``, ``parallel.batch.ShardedRenderer``,
``runtime.fleet.FleetEngine(mesh=...)``) and checks it against the
unsharded fleet. Where the JAX entry points ``jax.jit`` a step, these
run the compiled step (``jit_step``, ``jit_update``: a CUDA graph
replayed a call on the card, ``compiled.py``). Where the JAX dry run reads XLA's compiled program
(no full-frame all-gather, no collective on a hosts mesh), the port has
no compiled program: it checks where each device's tensors lie and
what shape each device's frame has.

Both run on the card unless the caller passes CPU devices; with no card
they raise. Where fewer cards are visible than the mesh asks for,
:func:`dryrun_multichip` repeats them (the port's mesh admits a device
more than once), so one card drives every part.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from glava_tpu_torch import renderer as renderer_mod
from glava_tpu_torch.config import loader
from glava_tpu_torch.device import resolve
from glava_tpu_torch.parallel.batch import (
    BatchedRenderer, ShardedRenderer, example_batch,
)
from glava_tpu_torch.parallel.mesh import make_mesh
from glava_tpu_torch.renderer import Renderer
from glava_tpu_torch.utils.timing import host_ms, update_bytes

TINY = ("setgeometry 0 0 64 64", "setbufsize 256", "setsamplesize 64",
        "setprintframes false")
HD = ("setgeometry 0 0 1920 1080", "setprintframes false")
BARS_512 = ("setgeometry 0 0 512 256", "setprintframes false")


def entry(device="cuda"):
    """``(fn, example_args)`` for the flagship single-stream step: PCM
    ring snapshot -> spectrum chains -> bars frame (512x256), as
    ``__graft_entry__.entry``. ``fn(state, audio, modified, time,
    interp_mod, gravity_g)`` is ``Renderer.jit_step()``, the compiled
    step whose state is donated: the new state and the (256, 512, 4)
    float32 frame on ``device`` (the step's static output, overwritten
    by its next call of the same branch)."""
    lc = loader.load(cli_requests=BARS_512, force_module="bars")
    r = Renderer(lc, device=device)
    rng = np.random.default_rng(0)
    audio = torch.as_tensor(
        rng.standard_normal((2, lc.cfg.bufsize)).astype(np.float32) * 0.2,
        device=r.device)
    step = r.jit_step()

    def fn(state, audio, modified, time, interp_mod, gravity_g):
        return step(state, audio, modified, time, interp_mod, gravity_g)

    example_args = (
        r.init_state(),
        audio,
        True,
        np.float32(0.0),
        np.float32(1.0),
        np.float32(lc.cfg.gravity_step / lc.cfg.nominal_ups),
    )
    return fn, example_args


def _devices(n_devices: int, devices) -> list[torch.device]:
    """The mesh's devices: the given ones, or the first ``n_devices``
    visible cards, repeated in turn where fewer are visible."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}): no CUDA device is visible; "
                "pass devices (for example ['cpu'] * 4)")
        devices = [f"cuda:{i % count}" for i in range(n_devices)]
    devices = [resolve(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}): {len(devices)} "
                         "devices given")
    print(f"dryrun_multichip devices: {[str(d) for d in devices]}")
    return devices


def _host_batch(n_streams: int, cfg) -> dict:
    """``example_batch``'s per-stream inputs, every one on the host (as
    a sharded step takes them)."""
    ex = example_batch(SimpleNamespace(n_streams=n_streams, cfg=cfg,
                                       device=torch.device("cpu")))
    ex["audio"] = ex["audio"].numpy()
    return ex


def _step(br, state, ex):
    """One compiled step of ``br`` (float32 frames)."""
    return br.jit_step(quantize=False)(
        state, ex["audio"], ex["modified"], ex["time"], ex["interp_mod"],
        ex["gravity_g"])


def _whole(sr: ShardedRenderer, frames) -> torch.Tensor:
    """Every device's (S_i, H_band, W, 4) frames put together on the
    host at their streams and rows."""
    w, h = sr.screen
    out = torch.empty((sr.n_streams, h, w, 4), dtype=frames[0].dtype)
    for f, (sl, (r0, r1)) in zip(frames, sr.blocks):
        out[sl, r0:r1] = f.cpu()
    return out


def _on_own_devices(sr: ShardedRenderer, states, frames) -> None:
    """Every tensor of each shard (its state, its frame, its pipeline's
    window and weights) on that shard's device: no shard reads another
    device's memory."""
    for k, (dev, st, fr) in enumerate(zip(sr.devices, states, frames)):
        pipe = sr.shards[k].renderer.pipeline
        tensors = [*st.chains, st.key_start, st.key_end, fr, pipe.window,
                   pipe.age_weights]
        away = [t.device for t in tensors if t.device != dev]
        if away:
            raise AssertionError(f"shard {k} on {dev} holds tensors on {away}")


def _parity(devices, mesh, requests, n_streams: int):
    """The sharded bars step against the unsharded one on the first
    device: (sharded renderer, states, frames, max abs difference)."""
    lc = loader.load(cli_requests=requests, force_module="bars")
    ex = _host_batch(n_streams, lc.cfg)
    sr = ShardedRenderer([lc], [0] * n_streams, mesh)
    states, frames = _step(sr, sr.init_state(), ex)
    br = BatchedRenderer(lc, n_streams=n_streams, device=devices[0])
    _, ref = _step(br, br.init_state(), ex)
    whole = _whole(sr, frames)
    if not torch.isfinite(whole).all():
        raise AssertionError("sharded frame is not finite")
    return sr, states, frames, float((whole - ref.cpu()).abs().max())


def dryrun_multichip(n_devices: int, devices=None, per_device: int = 64,
                     updates: int = 8) -> None:
    """Validate the multi-device path on an ``n_devices`` mesh, as
    ``__graft_entry__.dryrun_multichip`` does: (1) sharded-vs-unsharded
    parity at tiny shapes, (2) a realistic-shape sharded step (1080p
    frames, bufsize 4096) with each device's frame its band on that
    device, (3) a weak-scaling table of the update (1 device vs n), (4)
    a hosts mesh (n >= 4 and even) and (5) the FleetEngine serving loop
    on the mesh. Streams = data parallelism, frame rows = spatial
    parallelism. ``per_device`` and ``updates`` size the scaling table
    (:func:`_scaling_table`; the CPU tests pass a small table). Each
    part prints its ``dryrun_multichip ... OK`` line; a failed check
    raises."""
    devices = _devices(n_devices, devices)
    rows = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1

    # ---- (1) tiny-shape parity ---------------------------------------
    mesh = make_mesh(devices, rows=rows)
    S = max(2 * (n_devices // rows), n_devices)
    sr, _, frames, diff = _parity(devices, mesh, TINY, S)
    if diff > 1e-5:
        raise AssertionError(f"sharded vs unsharded frame diff {diff}")
    print(f"dryrun_multichip OK: mesh={mesh.shape} streams={S} "
          f"frame={(S, 64, 64, 4)} sharded-vs-unsharded diff={diff:.2e} "
          f"per-device frames={[tuple(f.shape) for f in frames]}")

    # ---- (2) realistic shapes: 1080p frames, bufsize 4096 ------------
    lc = loader.load(cli_requests=HD, force_module="bars")
    Sr = n_devices // rows
    sr = ShardedRenderer([lc], [0] * Sr, mesh)
    bands = renderer_mod.whole_frame_bands
    states, frames = _step(sr, sr.init_state(), _host_batch(Sr, lc.cfg))
    shards = len(sr.slices)
    want = (max(Sr // shards, 1), 1080 // rows, 1920, 4)
    got = {tuple(f.shape) for f in frames}
    if got != {want}:
        raise AssertionError(f"per-device frames {got}, expected {want}")
    _on_own_devices(sr, states, frames)
    if renderer_mod.whole_frame_bands != bands:
        raise AssertionError("bars rendered a whole frame to keep a band")
    if not all(bool(torch.isfinite(f).all()) for f in frames):
        raise AssertionError("realistic sharded frame is not finite")
    print(f"dryrun_multichip realistic OK: streams={Sr} frame="
          f"{(Sr, 1080, 1920, 4)} bufsize={lc.cfg.bufsize} per-device "
          f"frame={want} on its own device (no whole-frame band renders)")

    # ---- (3) weak-scaling table ---------------------------------------
    print("dryrun_multichip scaling OK:",
          _scaling_table(devices, n_devices, per_device, updates))

    # ---- (4) hosts mesh ------------------------------------------------
    if n_devices >= 4 and n_devices % 2 == 0:
        _dryrun_hosts(devices, n_devices)

    # ---- (5) the serving loop on the mesh -----------------------------
    _dryrun_fleet_engine(devices, n_devices)


def _scaling_table(devices, n_devices: int, per_device: int = 64,
                   updates: int = 8) -> dict:
    """windows/s of the spectrum update on 1 device vs all
    ``n_devices`` (streams-axis data parallelism at ``per_device``
    streams a device, 512x256 bars, weak scaling), host clock around
    ``updates`` updates of every shard back to back on fresh inputs,
    each a replay of the shard's ``jit_update`` (after a warm-up call
    that captures it);
    with the update's bytes a device in place of the JAX table's
    compiled flops (constant iff the streams divide over the devices)."""
    lc = loader.load(cli_requests=BARS_512, force_module="bars")
    out, nbytes = {}, {}
    for ndev in dict.fromkeys((1, n_devices)):
        mesh = make_mesh(devices[:ndev], rows=1)
        S = per_device * ndev
        sr = ShardedRenderer([lc], [0] * S, mesh)
        audio = _host_batch(S, lc.cfg)["audio"]
        runs = []
        for sh, (sl, _) in zip(sr.shards, sr.blocks):
            pipe = sh.renderer.pipeline
            a = torch.as_tensor(audio[sl], device=sh.device)
            g = np.full((sl.stop - sl.start,), np.float32(
                lc.cfg.gravity_step / lc.cfg.nominal_ups))
            runs.append([pipe.jit_update(),
                         pipe.init_state(batch=(a.shape[0],)),
                         [a * (1.0 + 1e-3 * k) for k in range(updates)], g])

        def step(i, runs=runs):
            for run in runs:
                update, chains, feeds, g = run
                run[1], _ = update(chains, feeds[i][:, 0], feeds[i][:, 1],
                                   None, None, g)

        ms = host_ms(step, updates, devices[:ndev])
        out[f"{ndev}dev"] = {"streams": S, "windows_per_s": S / (ms / 1e3)}
        chains = runs[0][1]
        nbytes[f"{ndev}dev"] = update_bytes(
            sr.shards[0].renderer.pipeline.sz, chains.count.shape[0],
            lc.cfg.avg_frames)
    w1 = out["1dev"]["windows_per_s"]
    wn = out[f"{n_devices}dev"]["windows_per_s"]
    out["weak_scaling_efficiency"] = wn / (w1 * n_devices)
    b1, bn = nbytes["1dev"], nbytes[f"{n_devices}dev"]
    out["per_device_update_bytes"] = {
        "1dev": b1, f"{n_devices}dev": bn,
        # 1.0 = the n-way division with no replicated work
        "division_efficiency": b1 / bn}
    distinct = len(set(devices))
    if distinct < n_devices:
        out["note"] = (f"{n_devices} shards on {distinct} distinct device(s): "
                       "shards on one device share it, so the aggregate is "
                       "bounded by that device, not scaled")
    return out


def _dryrun_hosts(devices, n_devices: int) -> None:
    """A ('hosts', 'streams', 'rows') mesh: streams shard over hosts and
    streams, each shard alone on its device (the JAX dry run's zero
    collectives), parity with the unsharded step."""
    mesh = make_mesh(devices, hosts=2, rows=1)
    sr, states, frames, diff = _parity(devices, mesh, TINY, n_devices)
    if diff > 1e-5:
        raise AssertionError(f"hosts-mesh vs unsharded frame diff {diff}")
    _on_own_devices(sr, states, frames)
    print(f"dryrun_multichip hosts OK: mesh={mesh.shape} streams over "
          f"('hosts','streams'), every shard's state, frame and weights on "
          f"its own device (no cross-device traffic a step), "
          f"vs-unsharded diff={diff:.2e}")


def _dryrun_fleet_engine(devices, n_devices: int) -> None:
    """The FleetEngine serving loop (audio threads, mixed modules,
    per-stream sinks) on the mesh: every stream gets its frames in
    order and draws pixels; each device's frames are its (stream block,
    row band) on that device. The loop starts once every synth thread
    has delivered its first buffer (``FleetEngine.run``'s
    ``wait_audio``), so what is drawn does not hang on how soon the
    threads are scheduled."""
    from glava_tpu_torch.runtime.fleet import FleetEngine, StreamSpec
    from glava_tpu_torch.runtime.sinks import FrameSink

    rows = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(devices, rows=rows)

    class RecordingSink(FrameSink):
        def __init__(self):
            self.times: list[float] = []
            self.checksums: list[int] = []

        def submit(self, frame, time_s):
            self.times.append(float(time_s))
            self.checksums.append(int(np.asarray(frame).sum()))

    # Radial and circle default to C_RADIUS 128, a ring wholly outside a
    # 64x64 frame: user knob files shrink it so that every module draws
    with tempfile.TemporaryDirectory() as td:
        knobs = Path(td)
        (knobs / "radial.glsl").write_text("#define C_RADIUS 12\n"
                                           "#define NBARS 32\n")
        (knobs / "circle.glsl").write_text("#define C_RADIUS 12\n")
        variants = [loader.load(cli_requests=TINY, force_module=m,
                                user_dir=knobs)
                    for m in ("bars", "radial", "wave", "circle")]
    S = max(2 * max(n_devices // rows, 1), 8)
    sinks = [RecordingSink() for _ in range(S)]
    streams = [StreamSpec(name=f"s{i}", audio_backend="synth", sink=sinks[i],
                          loaded=variants[i % len(variants)])
               for i in range(S)]
    eng = FleetEngine(variants[0], streams, mesh=mesh)
    eng.run(max_frames=6, wait_audio=60.0)
    delivered = [len(s.times) for s in sinks]
    if min(delivered) < 5:
        raise AssertionError(f"streams missed frames: {delivered}")
    for i, s in enumerate(sinks):
        if s.times != sorted(s.times):
            raise AssertionError(f"stream {i} out of order")
    blank = [streams[i].name for i, s in enumerate(sinks)
             if not any(c > 0 for c in s.checksums)]
    if blank:
        raise AssertionError(f"{len(blank)}/{S} streams drew no pixels: "
                             f"{blank}")
    cfg = variants[0].cfg
    frames = eng.step(np.zeros((S, 2, cfg.bufsize), np.float32),
                      np.zeros((S,), bool), 0.0, np.ones((S,), np.float32),
                      np.full((S,), 0.05, np.float32))
    for f, dev, (sl, (r0, r1)) in zip(frames, eng.br.devices, eng.br.blocks):
        want = (sl.stop - sl.start, r1 - r0, 64, 4)
        if tuple(f.shape) != want or f.device != dev:
            raise AssertionError(f"device {dev}'s frames {tuple(f.shape)} on "
                                 f"{f.device}, expected {want} on {dev}")
    print(f"dryrun_multichip engine_{n_devices}dev OK: {S}-stream "
          f"heterogeneous fleet served {min(delivered)}+ frames/stream in "
          f"order on mesh={mesh.shape} ({S}/{S} streams drew pixels); each "
          f"device's frames its stream block and row band on that device")

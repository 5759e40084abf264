"""FleetEngine: serve many visualizer streams from one card.

The port of ``glava_tpu/runtime/fleet.py``. N independent audio sources
batch onto one device step per frame (one fused spectrum update and
one raster launch for the whole fleet), and each stream's frames flow
to its own sink. Per frame the engine makes one host-to-device copy of
the (S, 2, bufsize) ring snapshots, one step, and one device-to-host
copy of the (S, H, W, 4) uint8 frames into pinned memory
(:meth:`FleetEngine.fetch`), which it hands to the sinks.

An unsharded fleet's :meth:`FleetEngine.run` keeps one frame in
flight, through the single-stream engine's ``FrameFetch`` at depth 1:
frame k is copied on the compute stream into a device ring slot, then
from the slot into pinned host memory on a side stream, while the loop
takes frame k+1's snapshots and launches its step. Frame k goes to
every sink, with frame k's time, as soon as the loop finds its copy
ended (it checks every :data:`POLL` snapshots and after the step), and
at the latest when frame k+1 is pushed, which waits for frame k's copy.
The run hands its last frame off before the sinks close, so each stream
gets one frame for each snapshot, in order.

Streams whose ``StreamSpec.loaded`` differs from the engine's run other
modules in the same step (:class:`MixedBatchedRenderer`). Per-stream
dynamics (gravity feedback from each stream's measured UPS, kcounter
interpolation) mirror the single-stream engine loop, and the fused
update keeps per-row ring-slot counters, so streams on independent
audio clocks behave as separate engines would. Pipe values
(``StreamSpec.pipe``, e.g. ``fg``/``bg`` colours) are per stream and
change live with :meth:`FleetEngine.set_pipe`, with no rebuild.

With ``mesh`` (``parallel.mesh.make_mesh``) the fleet is sharded over
the mesh's devices (``parallel.batch.ShardedRenderer``), each taking a
block of streams and a band of rows: a frame makes one host-to-device
copy a device of its block's snapshots, one step a device, launched
back to back, and one pinned (S, H, W, 4) host buffer that every
device's frames are copied into at their streams and rows, with no
frame in flight.

The step is the compiled fleet step (``jit_step`` of the renderer: a
CUDA graph, one a device block on a mesh, replayed a frame,
``compiled.py``), as the JAX fleet jits its step
(glava_tpu/runtime/fleet.py:185-191): the snapshots go straight into
its static input, whatever its modules (native, GLSL shader or user
Python modules); a shader module's fuel counts are read at most once a
second and at the end of a run (``glsl_shader.fuel_check``).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from glava_tpu_torch.config import glsl_shader
from glava_tpu_torch.config.loader import LoadedConfig
from glava_tpu_torch.parallel.batch import (
    BatchedRenderer, MixedBatchedRenderer, ShardedRenderer,
)
from glava_tpu_torch.runtime import audio as audio_mod
from glava_tpu_torch.runtime.engine import FrameFetch
from glava_tpu_torch.runtime.sinks import FrameSink, make_sink
from glava_tpu_torch.utils import profiling


# snapshots between two checks for a frame in flight whose copy ended:
# a frame waits for the loop's next check, not for its next push
POLL = 8


@dataclass
class StreamSpec:
    """One fleet member: an audio source and a frame destination."""

    name: str
    audio_backend: str = "synth"
    source: str | None = None
    sink: FrameSink | str = "latest"
    pipe: dict[str, Any] = field(default_factory=dict)  # per-stream uniforms
    #: optional per-stream module/knob config — streams whose `loaded`
    #: differs from the engine's run other modules in the same step
    #: (MixedBatchedRenderer); DSP-shaping config must match
    loaded: LoadedConfig | None = None


class FleetDynamics:
    """Per-stream frame-clock dynamics, the vectorized mirror of the
    single-stream engine loop (render.c:728, 1792-1809, 2380-2399):
    per-stream kcounter-driven interpolation and measured-UPS gravity
    feedback with the nominal/8 stall guard."""

    def __init__(self, n_streams: int, nominal_ups: float, framerate: float):
        self.S = n_streams
        self.nominal_ups = float(nominal_ups)
        self.fr = max(float(framerate) or 60.0, 1.0)
        self.ur = np.full((n_streams,), self.nominal_ups, np.float64)
        self.kcounter = np.zeros((n_streams,), np.int64)
        self.ucount = np.zeros((n_streams,), np.int64)
        self.ups = np.zeros((n_streams,), np.float64)

    def frame(self, mods: np.ndarray, fps: float):
        """Advance one frame: returns the (S,) f32 interpolation mod
        (gravity decay comes from the separate :meth:`gravity`)."""
        self.kcounter = np.where(mods, 0, self.kcounter + 1)
        uratio = np.minimum(self.ur / max(fps or self.fr, 1.0), 1.0)
        interp = np.minimum(
            uratio * np.maximum(self.kcounter, 1), 1.0
        ).astype(np.float32)
        self.ucount += mods
        return interp

    def gravity(self, gravity_step: float) -> np.ndarray:
        return (gravity_step / np.maximum(self.ur, 1.0)).astype(np.float32)

    def tick(self, span: float) -> np.ndarray:
        """Per-second accounting: returns per-stream UPS and feeds the
        measured rate into the gravity step (stall-guarded)."""
        self.ups = self.ucount / max(span, 1e-9)
        self.ur = np.maximum(self.ups, self.nominal_ups / 8.0)
        self.ucount = np.zeros((self.S,), np.int64)
        return self.ups


class FleetEngine:
    """Multi-stream serving engine on one device (``"cuda"`` unless the
    caller asks for ``"cpu"``), or sharded over the devices of ``mesh``
    (then ``device`` is not read)."""

    def __init__(self, loaded: LoadedConfig, streams: list[StreamSpec],
                 screen: tuple[int, int] | None = None, device="cuda",
                 mesh=None):
        if not streams:
            raise ValueError("fleet needs at least one stream")
        self.loaded = loaded
        self.streams = streams
        # heterogeneous fleets: group streams by module-config variant
        variants: list[LoadedConfig] = [loaded]
        assign: list[int] = []
        for s in streams:
            lc = s.loaded if s.loaded is not None else loaded
            k = next((i for i, v in enumerate(variants) if v is lc), None)
            if k is None:
                variants.append(lc)
                k = len(variants) - 1
            assign.append(k)
        self.mesh = mesh
        if mesh is not None:
            self.br = ShardedRenderer(variants, assign, mesh, screen=screen)
        elif len(variants) == 1:
            self.br = BatchedRenderer(loaded, n_streams=len(streams),
                                      screen=screen, device=device)
        else:
            self.br = MixedBatchedRenderer(variants, assign, screen=screen,
                                           device=device)
        # the device of an unsharded fleet (a mesh's are br.devices)
        self.device = None if mesh is not None else self.br.device
        cfg = loaded.cfg
        self.sinks: list[FrameSink] = [
            s.sink if isinstance(s.sink, FrameSink) else make_sink(s.sink)
            for s in streams
        ]
        self.audio: list[audio_mod.AudioData] = []
        self.backends = []
        for s in streams:
            ad = audio_mod.make_audio_data(
                bufsize=cfg.bufsize, sample_sz=cfg.samplesize,
                rate=cfg.sample_rate,
                channels=1 if cfg.mirror_input else 2,
                source=s.source if s.source is not None else cfg.audio_source,
            )
            backend = audio_mod.lookup(s.audio_backend)
            backend.init(ad)
            self.audio.append(ad)
            self.backends.append(backend)
        # stacked per-stream pipe values (static structure, live-updatable)
        names = sorted({k for s in streams for k in s.pipe})
        self._pipe_host = {
            n: np.stack([
                np.asarray(s.pipe.get(n, self._default_pipe(n)), np.float32)
                for s in streams
            ])
            for n in names
        }
        self.state = self.br.init_state()
        self._step = self._make_step()
        self.alive = False
        self.frames_rendered = 0
        self._inflight: FrameFetch | None = None    # a run's, unsharded
        self._loop = profiling.new_loop()   # the id of its spans
        self.fps = 0.0
        self.ups = np.zeros((len(streams),), np.float64)  # per-stream

    def _default_pipe(self, name):
        for s in self.streams:
            if name in s.pipe:
                return np.zeros_like(np.asarray(s.pipe[name], np.float32))
        return 0.0

    def _make_step(self):
        """The compiled fleet step."""
        self._shader = any(r.module.kind == "shader"
                           for r in self.br.used_renderers())
        return self.br.jit_step(quantize=True)

    def set_pipe(self, stream: int, name: str, value) -> None:
        """Live per-stream uniform update (no rebuild)."""
        self._pipe_host[name][stream] = np.asarray(value, np.float32)

    def step(self, snaps: np.ndarray, mods: np.ndarray, tnow: float,
             interp: np.ndarray, gravity_g: np.ndarray):
        """One fleet frame from host snapshots (S, 2, bufsize): the
        snapshots go to the device in one copy (one a mesh device);
        returns the (S, H, W, 4) uint8 frames on the device (on a mesh, a
        list of each device's (S_i, H_band, W, 4) frames on it), the
        compiled step's static output: the next step overwrites it."""
        S = len(self.streams)
        audio = snaps if self.mesh is not None else torch.from_numpy(snaps)
        self.state, frames = self._step(
            self.state, audio, mods, np.full((S,), tnow, np.float32), interp,
            gravity_g, self._pipe_host)
        if self._shader:
            glsl_shader.fuel_check()
        return frames

    def run(self, max_frames: int | None = None,
            max_seconds: float | None = None,
            wait_audio: float | None = None) -> None:
        """Serve frames until ``terminate``, ``max_frames`` or
        ``max_seconds``. With ``wait_audio`` (seconds) the loop starts
        once every stream's backend has delivered its first buffer, and
        raises ``TimeoutError`` naming the streams still silent after
        that long; without it the loop starts at once, as the reference
        renders before any audio arrives."""
        cfg = self.loaded.cfg
        S = len(self.streams)
        threads = [b.spawn(a) for b, a in zip(self.backends, self.audio)]
        self.alive = True
        dyn = FleetDynamics(S, cfg.nominal_ups, cfg.framerate)
        t0 = _time.monotonic()
        fcount, mark = 0, t0
        snaps = np.empty((S, 2, cfg.bufsize), np.float32)
        mods = np.empty((S,), bool)
        # one frame in flight: its copy runs under the next frame's
        # snapshots and step (the module docstring)
        inflight = self._inflight = (FrameFetch(self.device, 1)
                                     if self.mesh is None else None)
        try:
            if wait_audio is not None:
                self._wait_audio(threads, wait_audio)
                t0 = mark = _time.monotonic()
            while self.alive:
                now = _time.monotonic()
                if max_seconds is not None and now - t0 >= max_seconds:
                    break
                # a frame's spans (utils/profiling.py)
                n = self.frames_rendered
                tf = profiling.frame_begin(self._loop, n)
                try:
                    for i, (ad, th) in enumerate(zip(self.audio, threads)):
                        if inflight is not None and not i % POLL:
                            self._hand_off(inflight.ready())
                        err = getattr(th, "error", None)
                        if err is not None:
                            raise RuntimeError(f"audio backend of stream {i} "
                                               f"failed: {err}") from err
                        snaps[i], mods[i] = ad.snapshot()
                    interp = dyn.frame(mods, self.fps)
                    gravity_g = dyn.gravity(cfg.gravity_step)
                    tnow = (now - t0) % cfg.timecycle
                    frames = self.step(snaps, mods, tnow, interp, gravity_g)
                    if inflight is not None:
                        self._hand_off(inflight.ready())
                    self._hand_off(self.fetch(frames, tnow))
                    self.frames_rendered += 1
                    fcount += 1
                    if now - mark >= 1.0:
                        span = now - mark
                        self.fps = fcount / span
                        self.ups = dyn.tick(span)
                        if cfg.print_frames:
                            print(f"FPS: {self.fps:.1f}, UPS: "
                                  f"{float(np.mean(self.ups)):.1f} (fleet mean)")
                        fcount, mark = 0, now
                    if max_frames is not None and self.frames_rendered >= max_frames:
                        break
                finally:
                    if tf:
                        profiling.frame_end(self._loop, n, tf)
        finally:
            self._inflight = None
            try:
                if inflight is not None:
                    # the frame still in flight, before the sinks close
                    self._hand_off(inflight.drain())
            finally:
                for ad in self.audio:
                    ad.terminate = True
                for t in threads:
                    t.join(timeout=2.0)
                # the next run's capture threads start anew
                for ad in self.audio:
                    ad.terminate = False
                for s in self.sinks:
                    s.close()
        if self._shader:
            glsl_shader.fuel_check(force=True)

    def _wait_audio(self, threads, timeout: float) -> None:
        end = _time.monotonic() + timeout
        for i, (ad, th) in enumerate(zip(self.audio, threads)):
            while not ad.delivered.wait(0.05):
                err = getattr(th, "error", None)
                if err is not None or _time.monotonic() >= end:
                    silent = [s.name for s, a in zip(self.streams, self.audio)
                              if not a.delivered.is_set()]
                    if err is not None:
                        raise RuntimeError(f"audio backend of stream {i} "
                                           f"failed: {err}") from err
                    raise TimeoutError(f"streams {silent} delivered no audio "
                                       f"in {timeout} s")

    def fetch(self, frames, t: float | None = None):
        """The hand-off of one step's ``frames``. Without ``t``: the
        (S, H, W, 4) uint8 frames on the host, copied at once (below).
        With ``t``, the frame's time (the serving loop's call): inside an
        unsharded fleet's :meth:`run` the frames join the run's
        ``FrameFetch`` (depth 1, the module docstring), and -> the (host
        frames, time) pairs now due, oldest first; elsewhere ->
        ``[(host frames, t)]``, copied at once.

        The copy at once: on CUDA into ONE fresh pinned tensor
        (``non_blocking``, then one synchronize a device), so the copy
        runs at the link's rate instead of a pageable copy's; no frame
        stays in flight, as in the JAX fleet.
        ``frames`` is one tensor or, on a mesh, a list of each device's
        (S_i, H_band, W, 4) frames, copied into their streams and rows.
        Every copy lands in a contiguous block of the buffer: one a
        device, or, for a band of a rows mesh, one a stream (a strided
        pinned destination would be copied through a pageable
        temporary). The copies run on each device's current stream, the
        one the step replays on, and end in a synchronize: the next step
        cannot overwrite a frame while it is copied. A failed pinned
        allocation or copy raises. While recording, ``fetch.wait``'s
        payload is 1 when a copy still ran as the wait began."""
        if t is None:
            return self._fetch_now(frames)
        if self._inflight is not None:
            return self._inflight.push(frames, t)
        return [(self._fetch_now(frames), t)]

    def _fetch_now(self, frames) -> np.ndarray:
        ts = profiling.begin()
        parts = frames if isinstance(frames, (list, tuple)) else [frames]
        S = len(self.streams)
        blocks = getattr(self.br, "blocks", [(slice(0, S), None)])
        if len(parts) != len(blocks):
            raise ValueError(f"{len(parts)} frame parts for {len(blocks)} "
                             "mesh devices")
        cuda = [f.device for f in parts if f.device.type == "cuda"]
        w, h = self.br.screen
        host = torch.empty((S, h, w, 4), dtype=parts[0].dtype,
                           pin_memory=bool(cuda))
        for f, (sl, band) in zip(parts, blocks):
            r0, r1 = band or (0, h)
            if tuple(f.shape) != (sl.stop - sl.start, r1 - r0, w, 4):
                raise ValueError(f"frames {tuple(f.shape)} do not fill "
                                 f"streams {sl} and rows [{r0}, {r1})")
            nb = f.device.type == "cuda"
            if r1 - r0 == h:
                host[sl].copy_(f, non_blocking=nb)
                continue
            for k, s in enumerate(range(sl.start, sl.stop)):
                host[s, r0:r1].copy_(f[k], non_blocking=nb)
        if ts:
            profiling.end("fetch.copy", ts)
        tw = profiling.begin()
        streams = [torch.cuda.current_stream(d) for d in dict.fromkeys(cuda)]
        running = int(bool(tw) and not all(s.query() for s in streams))
        for s in streams:
            s.synchronize()
        if tw:
            profiling.end("fetch.wait", tw, running)
        if ts:
            profiling.end("fetch", ts)
        return host.numpy()

    def _hand_off(self, ready: list) -> None:
        """Each (host frames, time) pair to every stream's sink."""
        if not ready:
            return
        ts = profiling.begin()
        for host, t in ready:
            for i, sink in enumerate(self.sinks):
                sink.submit(host[i], t)
        if ts:
            profiling.end("sink", ts)

    def tex(self, stream: int) -> np.ndarray | None:
        s = self.sinks[stream]
        return s.latest() if hasattr(s, "latest") else None

    def terminate(self) -> None:
        self.alive = False

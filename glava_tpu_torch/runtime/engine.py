"""Engine: the glava_entry / rd_update frame loop on torch.

Replicates the reference's process structure (glava/glava.c:291-577):
audio backend thread -> mutex ring -> per-frame snapshot -> device step
-> frame sink, with the control surface embedders use (glava.h:14-26):
``wait``, ``tex``, ``sizereq``, ``terminate``, ``reload``.

Loop mechanics carried over from the JAX package's engine:

* UPS/FPS accounting once per second when ``setprintframes``
  (render.c:2376-2399), with the measured UPS feeding the gravity step
  (render.c:728);
* the frame limiter via ``setframerate`` (render.c:2361-2372);
* reload: tear down and rebuild from config (glava.c:575-576);
* ``--pipe`` binds: live uniform values read from a stream each frame
  (render.c:1861-2005);
* the live ``setbgimg`` wallpaper, reloaded when the file changes
  (render.c:1832-1837);
* the frame's way to the host (:class:`FrameFetch`): the wire the sink
  takes (YUV420 packed on the device for a ``yuv420`` sink at large
  even sizes, else RGBA8) and up to ``inflight`` frames in flight, each
  copied on a side stream into pinned host memory while newer steps
  run;
* the compiled step: a frame is ``renderer.jit_step``'s (a CUDA graph
  a branch, replayed, ``compiled.py``), as the JAX engine runs
  ``jit_step``, for native, GLSL shader and user Python modules alike
  (a user module that reads on the host is refused by name,
  ``compiled.user_pass``). A shader's loops count the pixels they
  truncate at the fuel cap on the device; the engine reads the count at
  most once a second and at the end of a run
  (``glsl_shader.fuel_check``).

Not carried over: the XLA compile cache (a graph is captured at a
branch's first frame, in the process).
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from glava_tpu_torch.config import glsl_shader
from glava_tpu_torch.config import loader as config_loader
from glava_tpu_torch.renderer import Renderer
from glava_tpu_torch.runtime import audio as audio_mod
from glava_tpu_torch.runtime.sinks import FrameSink, LatestFrameSink
from glava_tpu_torch.runtime.stdin_pipe import PipeBind, PipeReader
from glava_tpu_torch.utils import profiling


@dataclass
class EngineOptions:
    entry: str = "rc.glsl"
    user_dir: str | None = None
    system_dir: str | None = None
    requests: tuple[str, ...] = ()
    force_module: str | None = None
    desktop: bool = False
    wm_name: str | None = None
    audio_backend: str = "pulseaudio"
    screen: tuple[int, int] | None = None
    pipe_binds: tuple[PipeBind, ...] = ()
    test_mode: bool = False
    verbose: bool = False
    device: str = "cuda"
    # device frames kept in flight before the host takes the oldest:
    # depth d overlaps d device steps with one device-to-host copy,
    # trading d frames of presentation latency for throughput
    # (GLAVA_TPU_INFLIGHT overrides)
    inflight: int = 1


def choose_wire(sink_wire: str, w: int, h: int, test_mode: bool) -> tuple:
    """The device-to-host wire of a frame (the JAX engine's rule): a
    sink declaring ``wire_format == "yuv420"`` gets YUV420 packed on the
    device, 1.5 B/px instead of RGBA8's 4, when the geometry is even,
    the frame holds at least 2^19 pixels (smaller frames gain nothing
    from the packing) and the golden test mode, which asserts on RGBA,
    is off. -> ``("yuv420", w, h)`` or ``("rgba8",)``."""
    if (sink_wire == "yuv420" and w % 2 == 0 and h % 2 == 0
            and w * h >= (1 << 19) and not test_mode):
        return ("yuv420", w, h)
    return ("rgba8",)


def inflight_depth(default: int) -> int:
    """Frames kept in flight: ``GLAVA_TPU_INFLIGHT`` when set, else
    ``default``; a malformed value is reported and ignored."""
    raw = os.environ.get("GLAVA_TPU_INFLIGHT", default)
    try:
        return max(int(raw), 0)
    except ValueError:
        print(f"glava_tpu: ignoring malformed GLAVA_TPU_INFLIGHT={raw!r}",
              file=sys.stderr)
        return max(default, 0)


class FrameFetch:
    """Device frames to host frames, oldest first, up to ``depth`` in
    flight.

    On CUDA each pushed frame is first copied on the compute stream
    into a ring of ``depth + 1`` device buffers, then from its ring
    buffer on a side stream, after the compute stream's work so far,
    into a fresh pinned host tensor (``non_blocking``), and an event
    marks the copy's end. A frame is handed out only after its event
    completed: once more than ``depth`` frames are queued, on
    :meth:`drain`, or on :meth:`ready` when it has. A step may write its
    frame into the same static buffer every call (a replayed CUDA
    graph's output): the ring buffer the side stream reads is written
    again only ``depth + 1`` pushes later, when its copy has been handed
    out. Each host tensor
    comes from the caching host allocator and is never written again
    after it is handed out: a sink may keep it (``LatestFrameSink``,
    ``AsyncSink``'s queue). A failed pinned allocation or copy raises;
    nothing falls back to a pageable copy. On the CPU the copy is a
    clone and the queue logic the same.

    ``wire`` is :func:`choose_wire`'s: a yuv420 frame is one contiguous
    uint8 buffer (Y, then U, then V) handed out as three (H, W),
    (H/2, W/2), (H/2, W/2) views of the host buffer.
    """

    def __init__(self, device, depth: int, wire: tuple = ("rgba8",)):
        self.device = torch.device(device)
        self.depth = max(int(depth), 0)
        self.wire = wire
        self._pending: collections.deque = collections.deque()
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._ring: list[torch.Tensor] = []
        self._pushes = 0

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, frame: torch.Tensor, t: float) -> list:
        """Queue ``frame`` (time ``t``); -> the (host frame, t) pairs now
        due, oldest first."""
        ts = profiling.begin()
        if self._copy is None:
            # a copy: the step may write its next frame into this buffer
            host = frame.clone()
            self._pending.append((host, host, None, t, self.wire))
        else:
            compute = torch.cuda.current_stream(self.device)
            k = self._pushes % (self.depth + 1)
            if (not self._ring or self._ring[0].shape != frame.shape
                    or self._ring[0].dtype != frame.dtype):
                self._ring = [torch.empty_like(frame)
                              for _ in range(self.depth + 1)]
            slot = self._ring[k]
            slot.copy_(frame)
            host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
            with torch.cuda.stream(self._copy):
                self._copy.wait_stream(compute)
                host.copy_(slot, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._copy)
            self._pending.append((slot, host, done, t, self.wire))
        if ts:
            profiling.end("fetch.copy", ts)
        self._pushes += 1
        out = []
        while len(self._pending) > self.depth:
            out.append(self._finish(self._pending.popleft()))
        if ts:
            profiling.end("fetch", ts)
        return out

    def ready(self) -> list:
        """The pending frames whose copies have ended, oldest first, with
        no wait (on the CPU: every pending frame)."""
        ts = profiling.begin()
        out = []
        while self._pending and (self._pending[0][2] is None
                                 or self._pending[0][2].query()):
            out.append(self._finish(self._pending.popleft()))
        if ts and out:
            profiling.end("fetch", ts)
        return out

    def drain(self) -> list:
        """Every pending frame, oldest first."""
        ts = profiling.begin()
        out = []
        while self._pending:
            out.append(self._finish(self._pending.popleft()))
        if ts:
            profiling.end("fetch", ts)
        return out

    @staticmethod
    def _finish(entry) -> tuple:
        _frame, host, done, t, wire = entry
        ts = profiling.begin()
        running = 0
        if done is not None:
            # while recording: whether the copy still ran as the wait began
            running = int(bool(ts) and not done.query())
            done.synchronize()
        if ts:
            profiling.end("fetch.wait", ts, running)
        buf = host.numpy()
        if wire[0] == "yuv420":
            _, w, h = wire
            n = h * w
            q = n // 4
            buf = (buf[:n].reshape(h, w),
                   buf[n:n + q].reshape(h // 2, w // 2),
                   buf[n + q:].reshape(h // 2, w // 2))
        return buf, t


class Engine:
    def __init__(self, opts: EngineOptions, sink: FrameSink | None = None,
                 pipe_stream=None):
        self.opts = opts
        self.sink = sink if sink is not None else LatestFrameSink()
        self._pipe_stream = pipe_stream
        self.pipe = None
        self.alive = False
        self._reload_flag = False
        self._stop = False
        self._sizereq: tuple[int, int] | None = None
        self._lock = threading.Lock()
        self.fps = 0.0
        self.ups = 0.0
        self.frames_rendered = 0
        self.updates = 0   # frames that ran the audio update (modified)
        self._loop = profiling.new_loop()   # the id of its spans
        self._build()

    # -- construction (rd_new equivalent) ---------------------------------

    def _build(self) -> None:
        o = self.opts
        pipe_defaults = {b.name: b.default_value() for b in o.pipe_binds}
        kwargs = {}
        if o.system_dir:
            kwargs["system_dir"] = o.system_dir
        entry = "test_rc.glsl" if o.test_mode and o.entry == "rc.glsl" else o.entry
        self.loaded = config_loader.load(
            entry=entry,
            user_dir=o.user_dir,
            cli_requests=o.requests,
            force_module=o.force_module,
            desktop=o.desktop,
            wm_name=o.wm_name,
            pipe_values=pipe_defaults,
            **kwargs,
        )
        cfg = self.loaded.cfg
        screen = self._sizereq if self._sizereq is not None else o.screen
        self._set_renderer(Renderer(self.loaded, screen=screen, device=o.device))
        self.state = self.renderer.init_state()
        self.audio = audio_mod.make_audio_data(
            bufsize=cfg.bufsize,
            sample_sz=cfg.samplesize,
            rate=cfg.sample_rate,
            channels=1 if cfg.mirror_input else 2,
            source=cfg.audio_source,
        )
        self.backend = audio_mod.lookup(o.audio_backend)
        self.backend.init(self.audio)
        # keep the existing reader across reloads (a second thread on
        # the same stream would steal lines from the first)
        if self.pipe is None and o.pipe_binds and self._pipe_stream is not None:
            self.pipe = PipeReader(list(o.pipe_binds), self._pipe_stream)

    def _set_renderer(self, renderer: Renderer) -> None:
        """Install a renderer and what hangs on its geometry: the wire,
        the step that produces it, and the wallpaper planes."""
        self.renderer = renderer
        w, h = renderer.screen
        self._wire = choose_wire(getattr(self.sink, "wire_format", "rgba8"),
                                 w, h, self.opts.test_mode)
        yuv = self._wire[0] == "yuv420"
        # the JAX engine's jit_step (glava_tpu/runtime/engine.py:116)
        self._step = renderer.jit_step(quantize=not yuv, yuv420=yuv)
        self._init_bg()

    # -- live wallpaper (bg_changed recopy, render.c:1832-1837) ------------

    def _init_bg(self) -> None:
        """When a `setbgimg` wallpaper composite is active, keep its
        planes on the device and feed them through the reserved
        ``__bg__`` pipe key, so a wallpaper change mid-run reaches the
        composite: the reference re-copies the root pixmap when the WM
        signals _XROOTPMAP_ID changed (glx_wcb.c:341-356); the signal
        here is the file's mtime, size and inode."""
        self._bg_dev = None
        self._bg_stat = None
        if self.renderer.bg_path:
            self._bg_stat = self._stat_bg()
            self._bg_dev = self._load_bg()

    def _load_bg(self) -> torch.Tensor:
        return torch.as_tensor(np.stack(self.renderer.load_bg_planes()),
                               device=self.renderer.device)

    def _stat_bg(self):
        try:
            st = os.stat(self.renderer.bg_path)
            return (st.st_mtime_ns, st.st_size, st.st_ino)
        except OSError:
            return None

    def _poll_bg(self) -> None:
        st = self._stat_bg()
        if st is None or st == self._bg_stat:
            return
        try:
            self._bg_dev = self._load_bg()
            self._bg_stat = st  # only on success: a torn read retries
        except Exception:
            pass  # file mid-write; keep the old composite, retry next frame

    # -- control API (glava.h parity) --------------------------------------

    def wait(self, timeout: float | None = 30.0) -> np.ndarray:
        """Block until the first frame exists (glava_wait, glava.c:243)."""
        if hasattr(self.sink, "wait"):
            return self.sink.wait(timeout)
        raise RuntimeError(
            "wait() needs a sink exposing wait() (e.g. 'latest' or "
            "'async:latest')"
        )

    def tex(self) -> np.ndarray | None:
        """Newest frame (glava_tex, glava.c:258-261)."""
        if hasattr(self.sink, "latest"):
            return self.sink.latest()
        return None

    def sizereq(self, w: int, h: int) -> None:
        """Atomic resize request (glava_sizereq, glava.c:264-268)."""
        with self._lock:
            self._sizereq = (w, h)

    def terminate(self) -> None:
        # sticky until run() returns: a terminate that lands while a
        # reload rebuilds would otherwise be undone by the next loop's
        # start (the JAX engine has that race)
        self._stop = True
        self.alive = False

    def reload(self) -> None:
        """SIGUSR1 semantics: teardown + re-instantiate (glava.c:280-286)."""
        self._reload_flag = True
        self.alive = False

    # -- frame loop -----------------------------------------------------------

    def run(self, max_frames: int | None = None, max_seconds: float | None = None):
        try:
            while True:
                self._run_once(max_frames, max_seconds)
                if self._reload_flag and not self._stop:
                    self._reload_flag = False
                    if self.opts.verbose:
                        print("reloading configuration")
                    self._build()
                    continue
                break
        finally:
            self._stop = self._reload_flag = False
        self.sink.close()

    def _submit(self, ready: list) -> None:
        ts = profiling.begin()
        for host, t in ready:
            self.sink.submit(host, t)
        if ts:
            profiling.end("sink", ts)

    def _run_once(self, max_frames, max_seconds):
        cfg = self.loaded.cfg
        o = self.opts
        self.alive = True
        audio_thread = self.backend.spawn(self.audio)
        if self.pipe:
            self.pipe.start()

        nominal_ups = cfg.nominal_ups
        ur = nominal_ups  # measured updates/sec (render.c:2380-2399)
        fr = max(float(cfg.framerate) or 60.0, 1.0)
        kcounter = 0      # frames since the last audio update
        fcount = ucount = 0
        sec_mark = _time.monotonic()
        t0 = _time.monotonic()
        frame_period = 1.0 / cfg.framerate if cfg.framerate > 0 else 0.0
        next_frame = _time.monotonic()
        depth = inflight_depth(o.inflight)
        fetch = FrameFetch(self.renderer.device, depth, self._wire)
        try:
            while self.alive and not self._stop:
                now = _time.monotonic()
                if max_seconds is not None and now - t0 >= max_seconds:
                    break
                with self._lock:
                    sr = self._sizereq
                if sr is not None and sr != self.renderer.screen:
                    # offscreen resize (render.c:1811-1815): hand out the
                    # frames in flight under the OLD geometry, then
                    # rebuild the raster for the new size, keeping the
                    # audio state
                    self._submit(fetch.drain())
                    self._set_renderer(Renderer(self.loaded, screen=sr,
                                                device=o.device))
                    fetch = FrameFetch(self.renderer.device, depth, self._wire)
                if self.sink.should_close():
                    break  # presentation target gone (window closed)
                if not self.sink.should_render():
                    _time.sleep(0.05)  # obscured/fullscreen gating
                    continue
                # a frame's spans (utils/profiling.py), from here to the
                # end of the iteration
                n = self.frames_rendered
                tf = profiling.frame_begin(self._loop, n)
                try:
                    # fail fast on capture errors, like the reference's
                    # exit-on-source-error (fifo.c:45-48)
                    err = getattr(audio_thread, "error", None)
                    if err is not None:
                        raise RuntimeError(f"audio backend failed: {err}") from err

                    snap, modified = self.audio.snapshot()
                    # keyframe interpolation phase (render.c:1792-1809); the
                    # step reads it on the CPU path only
                    kcounter = 0 if modified else kcounter + 1
                    uratio = min(ur / max(self.fps or fr, 1.0), 1.0)
                    interp_mod = min(uratio * max(kcounter, 1), 1.0)
                    tnow = (now - t0) % cfg.timecycle
                    gravity_g = cfg.gravity_step / max(ur, 1.0)
                    pipe = {k: np.asarray(v, np.float32)
                            for k, v in (self.pipe.snapshot() if self.pipe
                                         else {}).items()}
                    if self._bg_dev is not None:
                        self._poll_bg()
                        pipe["__bg__"] = self._bg_dev
                    self.state, frame = self._step(
                        self.state, snap, bool(modified),
                        tnow, float(np.float32(interp_mod)), gravity_g, pipe,
                    )
                    if self.renderer.module.kind == "shader":
                        glsl_shader.fuel_check(self.renderer.device)
                    # up to `depth` frames stay in flight: older frames'
                    # copies overlap newer frames' device work
                    self._submit(fetch.push(frame, tnow))
                    self.frames_rendered += 1
                    fcount += 1
                    if modified:
                        ucount += 1
                        self.updates += 1

                    if o.test_mode:
                        self._test_result = self.renderer.test_evaluate(frame)
                        self.alive = False
                        break
                    if max_frames is not None and self.frames_rendered >= max_frames:
                        break

                    # frame limiter (render.c:2361-2372)
                    if frame_period > 0:
                        next_frame += frame_period
                        delay = next_frame - _time.monotonic()
                        if delay > 0:
                            _time.sleep(delay)

                    # FPS/UPS accounting (render.c:2376-2399)
                    now2 = _time.monotonic()
                    if now2 - sec_mark >= 1.0:
                        span = now2 - sec_mark
                        self.fps = fcount / span
                        self.ups = ucount / span
                        # feed the measured rate into the gravity step
                        # (render.c:728), guarded against stalls
                        ur = max(self.ups, nominal_ups / 8.0)
                        if cfg.print_frames:
                            print(f"FPS: {self.fps:.1f}, UPS: {self.ups:.1f}")
                        fcount = ucount = 0
                        sec_mark = now2
                finally:
                    if tf:
                        profiling.frame_end(self._loop, n, tf)
        finally:
            self._submit(fetch.drain())
            self.audio.terminate = True
            audio_thread.join(timeout=2.0)
            self.audio.terminate = False
        if self.renderer.module.kind == "shader":
            glsl_shader.fuel_check(self.renderer.device, force=True)

    # -- golden test mode (render.c:2419-2453, glava.c:548-562) ---------------

    def run_tests(self) -> bool:
        self._test_result = False
        self.run(max_frames=1)
        return self._test_result

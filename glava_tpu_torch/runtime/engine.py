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
* reload: tear down and rebuild from config (glava.c:575-576).

Not carried over: the XLA compile cache (torch runs eagerly), on-device
YUV packing and wallpaper polling, and ``--pipe`` binds (ROADMAP
slice 5).
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from glava_tpu_torch.config import loader as config_loader
from glava_tpu_torch.renderer import Renderer
from glava_tpu_torch.runtime import audio as audio_mod
from glava_tpu_torch.runtime.sinks import FrameSink, LatestFrameSink


@dataclass
class EngineOptions:
    entry: str = "rc.glsl"
    user_dir: str | None = None
    system_dir: str | None = None
    requests: tuple[str, ...] = ()
    force_module: str | None = None
    desktop: bool = False
    wm_name: str | None = None
    audio_backend: str = "synth"
    screen: tuple[int, int] | None = None
    pipe_binds: tuple = ()
    test_mode: bool = False
    verbose: bool = False
    device: str = "cuda"


class Engine:
    def __init__(self, opts: EngineOptions, sink: FrameSink | None = None):
        if opts.pipe_binds:
            raise NotImplementedError(
                "--pipe uniforms are not yet ported (ROADMAP slice 5)")
        self.opts = opts
        self.sink = sink if sink is not None else LatestFrameSink()
        self.alive = False
        self._reload_flag = False
        self._sizereq: tuple[int, int] | None = None
        self._lock = threading.Lock()
        self.fps = 0.0
        self.ups = 0.0
        self.frames_rendered = 0
        self.updates = 0   # frames that ran the audio update (modified)
        self._build()

    # -- construction (rd_new equivalent) ---------------------------------

    def _build(self) -> None:
        o = self.opts
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
            **kwargs,
        )
        cfg = self.loaded.cfg
        screen = self._sizereq if self._sizereq is not None else o.screen
        self.renderer = Renderer(self.loaded, screen=screen, device=o.device)
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

    # -- control API (glava.h parity) --------------------------------------

    def wait(self, timeout: float | None = 30.0) -> np.ndarray:
        """Block until the first frame exists (glava_wait, glava.c:243)."""
        if hasattr(self.sink, "wait"):
            return self.sink.wait(timeout)
        raise RuntimeError("wait() needs a sink exposing wait() (e.g. 'latest')")

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
        self.alive = False

    def reload(self) -> None:
        """SIGUSR1 semantics: teardown + re-instantiate (glava.c:280-286)."""
        self._reload_flag = True
        self.alive = False

    # -- frame loop -----------------------------------------------------------

    def run(self, max_frames: int | None = None, max_seconds: float | None = None):
        while True:
            self._run_once(max_frames, max_seconds)
            if self._reload_flag:
                self._reload_flag = False
                if self.opts.verbose:
                    print("reloading configuration")
                self._build()
                continue
            break
        self.sink.close()

    def _run_once(self, max_frames, max_seconds):
        cfg = self.loaded.cfg
        o = self.opts
        self.alive = True
        audio_thread = self.backend.spawn(self.audio)

        nominal_ups = cfg.nominal_ups
        ur = nominal_ups  # measured updates/sec (render.c:2380-2399)
        fcount = ucount = 0
        sec_mark = _time.monotonic()
        t0 = _time.monotonic()
        frame_period = 1.0 / cfg.framerate if cfg.framerate > 0 else 0.0
        next_frame = _time.monotonic()
        try:
            while self.alive:
                now = _time.monotonic()
                if max_seconds is not None and now - t0 >= max_seconds:
                    break
                with self._lock:
                    sr = self._sizereq
                if sr is not None and sr != self.renderer.screen:
                    # offscreen resize (render.c:1811-1815): rebuild the
                    # raster for the new size, keeping the audio state
                    self.renderer = Renderer(self.loaded, screen=sr,
                                             device=o.device)
                if self.sink.should_close():
                    break  # presentation target gone (window closed)
                if not self.sink.should_render():
                    _time.sleep(0.05)  # obscured/fullscreen gating
                    continue
                # fail fast on capture errors, like the reference's
                # exit-on-source-error (fifo.c:45-48)
                err = getattr(audio_thread, "error", None)
                if err is not None:
                    raise RuntimeError(f"audio backend failed: {err}") from err

                snap, modified = self.audio.snapshot()
                tnow = (now - t0) % cfg.timecycle
                gravity_g = cfg.gravity_step / max(ur, 1.0)
                self.state, frame = self.renderer.step_u8(
                    self.state, torch.from_numpy(snap), bool(modified),
                    tnow, 1.0, gravity_g,
                )
                host = frame.cpu().numpy()
                self.sink.submit(host, tnow)
                self.frames_rendered += 1
                fcount += 1
                if modified:
                    ucount += 1
                    self.updates += 1

                if o.test_mode:
                    self._test_result = self.renderer.test_evaluate(host)
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
            self.audio.terminate = True
            audio_thread.join(timeout=2.0)
            self.audio.terminate = False

    # -- golden test mode (render.c:2419-2453, glava.c:548-562) ---------------

    def run_tests(self) -> bool:
        self._test_result = False
        self.run(max_frames=1)
        return self._test_result

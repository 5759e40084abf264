"""Embedding API — the libglava surface (glava/glava.h:14-26).

The reference exposes a tiny stable C API consumed by its CLI and the
OBS plugin: spawn the whole app on a thread, wait for the offscreen
texture, fetch/resize it, terminate or reload atomically
(glava/glava.c:243-286, glava-obs/entry.c:141-214). The TPU-native
equivalent hands embedders a frame-stream handle instead of a GL
texture name. The port's handle drives its own :class:`Engine`; the
argv is the port's CLI, so ``--device`` picks the card or the CPU:

    import glava_tpu_torch.api as glava

    h = glava.entry(["--audio", "synth"])   # spawns the engine thread
    glava.wait(h)                           # blocks until frames flow
    frame = glava.tex(h)                    # newest uint8 RGBA (H,W,4)
    glava.sizereq(h, 0, 0, 1280, 720)       # live resize
    glava.reload(h)                         # SIGUSR1-equivalent
    glava.terminate(h)

``abort_hook`` / ``return_hook`` mirror the overridable
``glava_abort``/``glava_return`` function pointers (glava.h:17-18) so a
host application survives engine failure.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from glava_tpu_torch.runtime.engine import Engine, EngineOptions
from glava_tpu_torch.runtime.sinks import LatestFrameSink

abort_hook: Callable[[BaseException], None] | None = None
return_hook: Callable[[], None] | None = None


@dataclass
class Handle:
    """An opaque handle to a running engine (glava_handle equivalent)."""

    engine: Engine
    thread: threading.Thread
    error: BaseException | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def alive(self) -> bool:
        return self.thread.is_alive()


def entry(argv: list[str] | None = None, **engine_opts) -> Handle:
    """Start the visualizer on a background thread (glava_entry +
    the OBS plugin's work_thread pattern, glava-obs/entry.c:111-115).

    ``argv`` takes CLI-style flags; keyword options override
    :class:`~glava_tpu_torch.runtime.engine.EngineOptions` fields
    directly.
    """
    import shutil

    from glava_tpu_torch import cli

    args = cli.build_parser().parse_args(argv or [])
    backend = args.audio or ("pulseaudio" if shutil.which("parec") else "synth")

    screen = None
    if args.size:
        w, _, hgt = args.size.partition("x")
        screen = (int(w), int(hgt))
    opts = EngineOptions(
        entry=args.entry,
        user_dir=args.config_dir or cli.default_user_dir(),
        requests=tuple(args.request),
        force_module=args.force_mod,
        desktop=args.desktop,
        audio_backend=backend,
        screen=screen,
        verbose=args.verbose,
        device=args.device,
    )
    for k, v in engine_opts.items():
        setattr(opts, k, v)

    engine = Engine(opts, sink=LatestFrameSink())

    def run():
        try:
            engine.run()
            if return_hook:
                return_hook()
        except BaseException as e:  # noqa: BLE001 — surfaced via handle
            h.error = e
            if abort_hook:
                abort_hook(e)
            else:
                raise

    thread = threading.Thread(target=run, daemon=True, name="glava-tpu-torch-engine")
    h = Handle(engine=engine, thread=thread)
    thread.start()
    return h


def wait(h: Handle, timeout: float | None = 30.0) -> None:
    """Block until the first frame is available (glava_wait)."""
    h.engine.wait(timeout)


def tex(h: Handle) -> np.ndarray | None:
    """Newest rendered frame, uint8 RGBA bottom-up (glava_tex)."""
    return h.engine.tex()


def sizereq(h: Handle, x: int, y: int, w: int, hgt: int) -> None:
    """Atomic resize request (glava_sizereq; x/y kept for signature
    parity, only the size has offscreen meaning)."""
    h.engine.sizereq(w, hgt)


def terminate(h: Handle) -> None:
    """Stop and join (glava_terminate + pthread_join)."""
    h.engine.terminate()
    h.thread.join(timeout=10.0)


def reload(h: Handle) -> None:
    """Hot config reload (glava_reload / SIGUSR1 semantics)."""
    h.engine.reload()

"""One stream through the live ``Engine``, as ``python -m glava_tpu_torch``
runs it: the entry file and requests of the configuration (and its
``force_module``, the CLI's ``-m``, when it names one; its ``user_dir``,
the CLI's ``--config-dir``, a directory relative to the repository's
root, when it names one), the benchmark's capture thread, one
:class:`StampSink`, the Engine's own in-flight depth. Warm-up and window
are each one ``Engine.run``."""

from __future__ import annotations

from pathlib import Path

import torch

from benchlib import live
from benchlib.system import System, bound_names, program_rows, verify

ROOT = Path(__file__).resolve().parents[2]


class EngineSystem(System):
    def __init__(self, config: dict, traffic: dict, rec: live.Recorder,
                 devices: list):
        from glava_tpu_torch.runtime.engine import (Engine, EngineOptions,
                                                    FrameFetch)

        if int(traffic["streams"]) != 1:
            raise ValueError("the engine drives one stream")
        self.devices = [torch.device(devices[0])]
        self.sinks = [live.StampSink()]
        user_dir = config.get("user_dir")
        self.engine = eng = Engine(EngineOptions(
            entry=config["entry"], requests=tuple(config["requests"]),
            force_module=config.get("force_module"),
            user_dir=None if user_dir is None else str(ROOT / user_dir),
            audio_backend=live.BACKEND, device=str(self.devices[0])),
            sink=self.sinks[0])
        verify(config, [eng.loaded])
        self.modules = [eng.loaded.module]
        self.pipe = {}
        self.rec = rec
        rec.wrap_snapshot(0, eng.audio, eng.backend)
        # Engine._step(state, snap, modified, time, interp, gravity, pipe)
        rec.wrap_step(eng, gravity_arg=5, time_arg=3)
        self._push = FrameFetch.push
        FrameFetch.push = rec.span(FrameFetch.push, rec.fetches)
        w, h = eng.renderer.screen
        dsp = config["dsp"]
        self.shapes = {"n": int(dsp["bufsize"]), "F": int(dsp["avg_frames"]),
                       "H": h, "W": w,
                       "rows": [len(eng.renderer.pipeline.fft_uniforms)],
                       "bars_streams": [int(self.modules[0] == "bars")],
                       "color_rows": [1]}

    def warm(self, seconds: float) -> None:
        self.engine.run(max_seconds=seconds)

    def window(self, seconds: float) -> None:
        self.engine.run(max_seconds=seconds)

    def state(self) -> dict:
        eng = self.engine
        pipeline = eng.renderer.pipeline
        return program_rows([(eng.state.chains, pipeline, [
            bound_names(pipeline, eng.renderer.uniforms)])])

    def close(self) -> None:
        from glava_tpu_torch.runtime.engine import FrameFetch

        FrameFetch.push = self._push
        self.engine = None


def build(config, traffic, rec, devices, seed) -> System:
    return EngineSystem(config, traffic, rec, devices)

"""Many streams through ``FleetEngine`` on one card: stream ``i`` runs
module ``modules[i % len(modules)]`` of the configuration, with its own
capture thread, its own :class:`StampSink` and its own seeded
``fg``/``bg`` pipe values. Warm-up and window are each one
``FleetEngine.run``."""

from __future__ import annotations

import numpy as np
import torch

from benchlib import live
from benchlib.system import System, bound_names, program_rows, verify


class FleetSystem(System):
    def __init__(self, config: dict, traffic: dict, rec: live.Recorder,
                 devices: list, seed: int):
        from glava_tpu_torch.config import loader
        from glava_tpu_torch.runtime.fleet import FleetEngine, StreamSpec

        S = int(traffic["streams"])
        names = list(config["modules"])
        loadeds = {m: loader.load(entry=config["entry"],
                                  cli_requests=tuple(config["requests"]),
                                  force_module=m) for m in names}
        verify(config, list(loadeds.values()))
        self.modules = [names[i % len(names)] for i in range(S)]
        rng = np.random.default_rng([seed & ((1 << 63) - 1), 11])
        # opaque colours, each stream its own (what fleet_serve.py sets)
        rgb = rng.uniform(0.1, 1.0, (2, S, 3)).astype(np.float32)
        ones = np.ones((S, 1), np.float32)
        self.pipe = {"fg": np.concatenate([rgb[0], ones], 1),
                     "bg": np.concatenate([rgb[1], ones], 1)}
        self.sinks = [live.StampSink() for _ in range(S)]
        streams = [StreamSpec(f"s{i}", audio_backend=live.BACKEND,
                              source=f"bench:{i}", sink=self.sinks[i],
                              pipe={k: tuple(v[i]) for k, v in self.pipe.items()},
                              loaded=loadeds[self.modules[i]])
                   for i in range(S)]
        self.fleet = fleet = FleetEngine(loadeds[names[0]], streams,
                                         device=str(devices[0]))
        self.devices = [torch.device(fleet.device)]
        for i, (ad, be) in enumerate(zip(fleet.audio, fleet.backends)):
            rec.wrap_snapshot(i, ad, be)
        # FleetEngine._step(state, audio, mods, time, interp, gravity, pipe)
        rec.wrap_step(fleet, gravity_arg=5, time_arg=3)
        fleet.fetch = rec.span(fleet.fetch, rec.fetches)
        br = fleet.br
        if hasattr(br, "pipeline"):      # a union pipeline over the modules
            self.pipeline = br.pipeline
            renderers = [br.renderers[a] for a in br.assign]
        else:
            self.pipeline = br.renderer.pipeline
            renderers = [br.renderer] * S
        self.binds = [bound_names(self.pipeline, r.uniforms)
                      for r in renderers]
        w, h = br.screen
        bars = sum(m == "bars" for m in self.modules)
        dsp = config["dsp"]
        # every stream holds a row for each of the pipeline's fft uniforms
        self.shapes = {"n": int(dsp["bufsize"]), "F": int(dsp["avg_frames"]),
                       "H": h, "W": w,
                       "rows": [len(self.pipeline.fft_uniforms) * S],
                       "bars_streams": [bars], "color_rows": [bars]}

    def warm(self, seconds: float) -> None:
        self.fleet.run(max_seconds=seconds, wait_audio=30.0)

    def window(self, seconds: float) -> None:
        self.fleet.run(max_seconds=seconds)

    def state(self) -> dict:
        return program_rows([(self.fleet.state.chains, self.pipeline,
                              self.binds)])

    def close(self) -> None:
        self.fleet = None


def build(config, traffic, rec, devices, seed) -> System:
    return FleetSystem(config, traffic, rec, devices, seed)

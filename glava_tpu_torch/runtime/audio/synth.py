"""Synthetic audio backend: deterministic tones for demos/bench/tests.

No reference equivalent (the reference has no test source; its CI runs
against whatever audio state exists). Produces a stereo chord with slow
amplitude modulation in real time, or as fast as the consumer wants
when ``realtime=False`` (bench mode).

Source string format: ``"synth"``, ``"synth:440,3000"`` (left,right Hz)
or ``"synth:noise"``.
"""

from __future__ import annotations

import time

import numpy as np

from glava_tpu_torch.runtime.audio import AudioBackend, AudioData, register


@register("synth")
class SynthBackend(AudioBackend):
    realtime = True

    def entry(self, audio: AudioData) -> None:
        hop = audio.hop
        rate = audio.rate
        spec = (audio.source or "").split(":", 1)
        args = spec[1] if len(spec) > 1 else ""
        noise = args == "noise"
        if args and not noise:
            fl, fr = (float(v) for v in args.split(","))
        else:
            fl, fr = 440.0, 3000.0
        rng = np.random.default_rng(1234)
        n = 0
        period = hop / rate
        next_t = time.monotonic()
        while not audio.terminate:
            t = (n + np.arange(hop)) / rate
            if noise:
                left = (rng.standard_normal(hop) * 0.1).astype(np.float32)
                right = (rng.standard_normal(hop) * 0.1).astype(np.float32)
            else:
                am = 0.3 + 0.2 * np.sin(2 * np.pi * 0.5 * t)
                left = (am * np.sin(2 * np.pi * fl * t)).astype(np.float32)
                right = (am * np.sin(2 * np.pi * fr * t)).astype(np.float32)
            audio.push(left, right)
            n += hop
            if self.realtime:
                next_t += period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

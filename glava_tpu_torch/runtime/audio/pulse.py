"""PulseAudio backend: float32 stereo capture from a sink monitor.

The reference blocks on ``pa_simple_read`` of float32 native-endian
stereo with fragsize = samplesize bytes from ``<default sink>.monitor``
(pulse_input.c:109-190). Capture uses the same ``pa_simple`` client API
through a ctypes binding (pa_simple.py) when libpulse is present, with
a ``parec``/``parecord`` subprocess fallback using identical format
flags; source discovery ("auto" -> default sink monitor) uses
``pactl``. Gated gracefully: a clear error if PulseAudio is absent
entirely (the reference exits likewise on connection failure,
pulse_input.c:128-135).
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np

from glava_tpu_torch.runtime.audio import AudioBackend, AudioData, register
from glava_tpu_torch.runtime.audio import pa_simple


def _default_monitor() -> str:
    out = subprocess.run(
        ["pactl", "get-default-sink"], capture_output=True, text=True, timeout=5
    )
    sink = out.stdout.strip()
    if not sink:
        raise RuntimeError("could not discover default PulseAudio sink")
    return sink + ".monitor"


@register("pulseaudio")
class PulseBackend(AudioBackend):
    #: injectable libpulse handle for tests (None = dlopen for real)
    libpulse = None

    def init(self, audio: AudioData) -> None:
        have_native = (self.libpulse is not None
                       or pa_simple.load_libpulse() is not None)
        have_parec = (shutil.which("parec") is not None
                      or shutil.which("parecord") is not None)
        if not have_native and not have_parec:
            raise RuntimeError(
                "PulseAudio capture requires libpulse-simple or `parec` "
                "(pulseaudio-utils); use the 'fifo', 'wav' or 'synth' "
                "backend instead"
            )
        if not audio.source or audio.source == "auto":
            audio.source = _default_monitor()

    # -- native pa_simple path (pulse_input.c:109-190) --------------------

    def _entry_native(self, audio: AudioData) -> None:
        cap = pa_simple.PaSimpleCapture(
            audio.source, audio.rate, audio.sample_sz, lib=self.libpulse
        )
        try:
            while not audio.terminate:
                s = cap.read()  # (sample_sz/2,) interleaved float32
                audio.push(s[0::2].copy(), s[1::2].copy())
        finally:
            cap.close()

    # -- parec subprocess fallback ----------------------------------------

    def _entry_parec(self, audio: AudioData) -> None:
        tool = shutil.which("parec") or shutil.which("parecord")
        hop = audio.hop
        proc = subprocess.Popen(
            [
                tool,
                "-d", audio.source,
                "--format=float32ne",
                f"--rate={audio.rate}",
                "--channels=2",
                "--latency=" + str(hop * 2 * 4),
            ],
            stdout=subprocess.PIPE,
        )
        frame_bytes = hop * 2 * 4
        try:
            while not audio.terminate:
                data = proc.stdout.read(frame_bytes)
                if not data or len(data) < frame_bytes:
                    break
                s = np.frombuffer(data, dtype=np.float32)
                audio.push(s[0::2].copy(), s[1::2].copy())
        finally:
            proc.terminate()

    def entry(self, audio: AudioData) -> None:
        if self.libpulse is not None or pa_simple.load_libpulse() is not None:
            self._entry_native(audio)
        else:
            self._entry_parec(audio)

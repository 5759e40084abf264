"""WAV-file playback backend: feed a track through the ring in real time.

No direct reference equivalent (closest: pointing the fifo backend at a
pre-recorded pipe); used for reproducible demos and golden-frame
comparisons against known audio.
"""

from __future__ import annotations

import time
import wave

import numpy as np

from glava_tpu_torch.runtime.audio import AudioBackend, AudioData, register


def read_wav(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sw == 2:
        s = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        s = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        s = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {sw}")
    if ch == 1:
        return s, s.copy(), rate
    s = s.reshape(-1, ch)
    return s[:, 0].copy(), s[:, 1].copy(), rate


@register("wav")
class WavBackend(AudioBackend):
    realtime = True
    loop = True

    def init(self, audio: AudioData) -> None:
        if not audio.source or audio.source == "auto":
            raise RuntimeError("the 'wav' backend needs `setsource \"/path.wav\"`")

    def entry(self, audio: AudioData) -> None:
        left, right, rate = read_wav(audio.source)
        if rate != audio.rate:
            # crude linear resample to the configured capture rate
            n = int(len(left) * audio.rate / rate)
            xs = np.linspace(0, len(left) - 1, n)
            left = np.interp(xs, np.arange(len(left)), left).astype(np.float32)
            right = np.interp(xs, np.arange(len(right)), right).astype(np.float32)
        hop = audio.hop
        period = hop / audio.rate
        next_t = time.monotonic()
        pos = 0
        while not audio.terminate:
            if pos + hop > len(left):
                if not self.loop:
                    break
                pos = 0
            audio.push(left[pos : pos + hop], right[pos : pos + hop])
            pos += hop
            if self.realtime:
                next_t += period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

"""Audio input backends.

Mirrors the reference's backend interface (glava/fifo.h:9-44): a
self-registering table of named implementations, each owning a capture
thread that shifts a shared stereo float ring left by ``samplesize/4``
samples per read and sets a ``modified`` flag, under one lock
(pulse_input.c:151-180, fifo.c:89-117).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from glava_tpu_torch.utils import profiling


@dataclass
class AudioData:
    """The shared producer/consumer ring (struct audio_data, fifo.h:9-20)."""

    buffer: np.ndarray                  # (2, bufsize) float32
    sample_sz: int                      # samples per update * 4 (ref units)
    rate: int
    channels: int                       # 1 = mono mixdown (setmirror)
    source: str | None = None
    lock: threading.Lock = field(default_factory=threading.Lock)
    modified: bool = False
    terminate: bool = False
    # set by the first push (a loop may wait for every stream's first)
    delivered: threading.Event = field(default_factory=threading.Event)

    @property
    def hop(self) -> int:
        return max(self.sample_sz // 4, 1)

    def push(self, left: np.ndarray, right: np.ndarray) -> None:
        """Shift the rings left by one hop and append new samples."""
        hop = len(left)
        with self.lock:
            self.buffer[:, :-hop] = self.buffer[:, hop:]
            if self.channels == 1:
                mono = (left + right) / 2.0
                self.buffer[0, -hop:] = mono
                self.buffer[1, -hop:] = mono
            else:
                self.buffer[0, -hop:] = left
                self.buffer[1, -hop:] = right
            self.modified = True
        if not self.delivered.is_set():
            self.delivered.set()

    def snapshot(self) -> tuple[np.ndarray, bool]:
        """Copy-out under the lock (glava.c:528-537)."""
        ts = profiling.begin()
        with self.lock:
            buf = self.buffer.copy()
            mod = self.modified
            self.modified = False
        if ts:
            profiling.end("snapshot", ts)
        return buf, mod


class NativeAudioData(AudioData):
    """AudioData backed by the C++ seqlock ring (``glava_tpu_torch.native``).

    Same interface; push/snapshot never contend on a Python lock and the
    snapshot copy runs in native code.
    """

    def __init__(self, bufsize: int, sample_sz: int, rate: int,
                 channels: int, source: str | None = None):
        from glava_tpu_torch.native import NativeRing

        super().__init__(
            buffer=np.zeros((2, bufsize), np.float32),
            sample_sz=sample_sz, rate=rate, channels=channels, source=source,
        )
        self.ring = NativeRing(bufsize)

    def push(self, left: np.ndarray, right: np.ndarray) -> None:
        self.ring.push(left, right, mono=self.channels == 1)
        if not self.delivered.is_set():
            self.delivered.set()

    def snapshot(self) -> tuple[np.ndarray, bool]:
        ts = profiling.begin()
        out = self.ring.snapshot()
        if ts:
            profiling.end("snapshot", ts)
        return out


def make_audio_data(bufsize: int, sample_sz: int, rate: int, channels: int,
                    source: str | None = None, prefer_native: bool = True):
    """AudioData factory: native ring when buildable, Python otherwise."""
    if prefer_native:
        from glava_tpu_torch import native

        if native.available():
            return NativeAudioData(bufsize, sample_sz, rate, channels, source)
    return AudioData(
        buffer=np.zeros((2, bufsize), np.float32),
        sample_sz=sample_sz, rate=rate, channels=channels, source=source,
    )


class AudioBackend:
    """One registered implementation (struct audio_impl)."""

    name: str = "?"

    def init(self, audio: AudioData) -> None:  # source discovery
        pass

    def entry(self, audio: AudioData) -> None:  # capture loop (own thread)
        raise NotImplementedError

    def spawn(self, audio: AudioData) -> threading.Thread:
        """Run the capture loop on a thread; failures are recorded on
        the thread object (`.error`) so the consumer can fail fast like
        the reference's exit-on-source-error (fifo.c:45-48,
        pulse_input.c:128-135)."""

        def run():
            try:
                self.entry(audio)
            except BaseException as e:  # noqa: BLE001 — surfaced to engine
                t.error = e

        t = threading.Thread(target=run, daemon=True, name=f"audio-{self.name}")
        t.error = None  # type: ignore[attr-defined]
        t.start()
        return t


_BACKENDS: dict[str, Callable[[], AudioBackend]] = {}


def register(name: str):
    """AUDIO_ATTACH equivalent (fifo.h:36-44)."""

    def deco(cls):
        cls.name = name
        _BACKENDS[name] = cls
        return cls

    return deco


def lookup(name: str) -> AudioBackend:
    try:
        return _BACKENDS[name]()
    except KeyError:
        raise KeyError(
            f"no such audio backend: '{name}' (available: {sorted(_BACKENDS)})"
        ) from None


def available() -> list[str]:
    return sorted(_BACKENDS)


from glava_tpu_torch.runtime.audio import fifo, pulse, synth, wav  # noqa: E402,F401

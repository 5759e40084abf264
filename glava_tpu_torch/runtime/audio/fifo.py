"""MPD FIFO backend: s16le interleaved stereo from a named pipe.

Behavior parity with glava/fifo.c:

* default path ``/tmp/mpd.fifo`` when the source is unset or "auto"
  (fifo.c:23-27);
* poll with an adaptive timeout measured from recent inter-read deltas
  (fifo.c:63-87);
* on timeout, synthesize silence by shifting the ring and zero-filling
  (producer stall handling, fifo.c:67-79);
* samples scaled by 1/65535 (yes — the reference divides s16 by 65535,
  giving a +-0.5 range; fifo.c:99-106), mono mixdown when requested.
"""

from __future__ import annotations

import os
import select
import time

import numpy as np

from glava_tpu_torch.runtime.audio import AudioBackend, AudioData, register

DEFAULT_PATH = "/tmp/mpd.fifo"


@register("fifo")
class FifoBackend(AudioBackend):
    def init(self, audio: AudioData) -> None:
        if not audio.source or audio.source == "auto":
            audio.source = DEFAULT_PATH

    def entry(self, audio: AudioData) -> None:
        # Native path: the C++ capture thread does everything (no GIL
        # on the capture side); this thread just supervises.
        ring = getattr(audio, "ring", None)
        if ring is not None:
            from glava_tpu_torch.native import NativeFifoReader

            reader = NativeFifoReader(
                ring, audio.source or DEFAULT_PATH, audio.hop,
                mono=audio.channels == 1,
            )
            try:
                while not audio.terminate:
                    if reader.running() < 0:
                        raise RuntimeError(
                            f"could not open FIFO source '{audio.source}' "
                            f"(errno {-reader.running()})"
                        )
                    time.sleep(0.05)
            finally:
                reader.stop()
            return
        self._python_entry(audio)

    def _python_entry(self, audio: AudioData) -> None:
        path = audio.source or DEFAULT_PATH
        hop = audio.hop
        frame_bytes = hop * 2 * 2  # hop frames * 2ch * s16
        try:
            fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
        except OSError as e:
            raise RuntimeError(f"could not open FIFO source '{path}': {e}") from e

        # adaptive timeout state (fifo.c:57-87): mean of the last 8
        # inter-read intervals, x2, min 10ms
        deltas = [0.05] * 8
        last = time.monotonic()
        pending = b""
        try:
            while not audio.terminate:
                timeout = max(2.0 * (sum(deltas) / len(deltas)), 0.010)
                r, _, _ = select.select([fd], [], [], timeout)
                if not r:
                    # producer stalled: synthesize silence
                    z = np.zeros(hop, np.float32)
                    audio.push(z, z)
                    continue
                try:
                    chunk = os.read(fd, frame_bytes - len(pending))
                except BlockingIOError:
                    continue
                if not chunk:
                    time.sleep(timeout)
                    continue
                pending += chunk
                if len(pending) < frame_bytes:
                    continue
                now = time.monotonic()
                deltas = deltas[1:] + [now - last]
                last = now
                s = np.frombuffer(pending[:frame_bytes], dtype="<i2").astype(np.float32)
                pending = pending[frame_bytes:]
                s /= 65535.0  # reference scaling (fifo.c:99-106)
                audio.push(s[0::2].copy(), s[1::2].copy())
        finally:
            os.close(fd)

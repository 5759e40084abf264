"""Frame sinks: where rendered RGBA frames go.

The reference presents through an X11/GLX window or hands an offscreen
GL texture to embedders (SURVEY.md L1/L7). The TPU-native capability
map (SURVEY.md section 7): "place output somewhere, suspend when not
needed" — a sink receives uint8 RGBA frames and can gate rendering
(the `should_render` role, glx_wcb.c:319-356).

Built-ins:

* ``null``     — drop frames (bench).
* ``latest``   — keep the newest frame for `tex()`-style consumers
  (the OBS-embedding analogue: a frame-stream handle, glava-obs/entry.c).
* ``raw``      — stream raw RGBA to a file/fd (pipe into ffmpeg etc.).
* ``y4m``      — YUV4MPEG2 stream, playable/encodable by mpv/ffmpeg/OBS.
* ``png``      — one PNG per frame (or the last frame), for debugging.

Frames arrive bottom-up (GL row order); sinks that write image formats
flip to top-down.
"""

from __future__ import annotations

import queue as _queue
import struct
import threading
import zlib
from pathlib import Path
from typing import BinaryIO, Callable

import numpy as np


class FrameSink:
    name = "?"

    def submit(self, frame: np.ndarray, time_s: float) -> None:
        raise NotImplementedError

    def should_render(self) -> bool:  # visibility gating hook
        return True

    def should_close(self) -> bool:
        """True when the presentation target is gone (window closed) —
        the engine exits its loop, like wcb should_close
        (glx_wcb.c:319-333)."""
        return False

    def close(self) -> None:
        pass


class NullSink(FrameSink):
    name = "null"

    def __init__(self):
        self.count = 0

    def submit(self, frame, time_s):
        self.count += 1


class LatestFrameSink(FrameSink):
    """Embedding handle: holds the newest frame under a lock + condition
    (the off_tex / glava_wait handshake, glava.c:243-261)."""

    name = "latest"

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._frame: np.ndarray | None = None
        self.count = 0

    def submit(self, frame, time_s):
        with self._cond:
            self._frame = frame
            self.count += 1
            self._cond.notify_all()

    def wait(self, timeout: float | None = None) -> np.ndarray:
        with self._cond:
            self._cond.wait_for(lambda: self._frame is not None, timeout)
            if self._frame is None:
                raise TimeoutError("no frame produced")
            return self._frame

    def latest(self) -> np.ndarray | None:
        with self._lock:
            return self._frame


class RawSink(FrameSink):
    """Raw RGBA32 stream (row order preserved, bottom-up)."""

    name = "raw"

    def __init__(self, fh: BinaryIO):
        self.fh = fh

    def submit(self, frame, time_s):
        self.fh.write(frame.tobytes())

    def close(self):
        self.fh.flush()


class Y4MSink(FrameSink):
    """YUV4MPEG2 stream for ffmpeg/mpv/OBS media sources.

    Default ``subsampling="420"`` (C420jpeg): the engine packs Y/U/V
    on DEVICE (renderer.yuv420_pack) and ``submit`` receives the three
    uint8 planes — 1.5 B/px on the wire vs RGBA8's 4 (the serving
    loop is transfer-bound on slow links). ``subsampling="444"`` keeps
    the legacy host-converted full-resolution chroma path; RGBA8
    ndarray input converts on host either way."""

    name = "y4m"

    def __init__(self, fh: BinaryIO, fps: float = 60,
                 subsampling: str = "420"):
        from fractions import Fraction

        self.fh = fh
        # rational frame rate: 29.97 -> 2997:100 etc., so the container
        # header matches the schedule frames were generated on
        fr = Fraction(str(fps or 60)).limit_denominator(10000)
        self.fps_num, self.fps_den = max(fr.numerator, 1), fr.denominator
        self.fps = float(self.fps_num / self.fps_den)
        self.subsampling = subsampling
        self._wrote_header = False

    @property
    def wire_format(self) -> str:
        return "yuv420" if self.subsampling == "420" else "rgba8"

    def _header(self, w: int, h: int, tag: str):
        if not self._wrote_header:
            self.fh.write(
                f"YUV4MPEG2 W{w} H{h} F{self.fps_num}:{self.fps_den} "
                f"Ip A1:1 {tag}\n".encode()
            )
            self._wrote_header = True

    def submit(self, frame, time_s):
        if isinstance(frame, tuple):
            # device-packed (Y, U, V) uint8 planes
            y = frame[0]
            self._header(y.shape[1], y.shape[0], "C420jpeg")
            self.fh.write(b"FRAME\n")
            for plane in frame:
                self.fh.write(np.asarray(plane).tobytes())
            return
        h, w = frame.shape[:2]
        if self.subsampling == "420" and h % 2 == 0 and w % 2 == 0:
            from glava_tpu_torch.renderer import yuv420_pack_host

            self._header(w, h, "C420jpeg")
            self.fh.write(b"FRAME\n")
            for plane in yuv420_pack_host(frame):
                self.fh.write(plane.tobytes())
            return
        self._header(w, h, "C444")
        self.fh.write(b"FRAME\n")
        # native conversion when available (glava_tpu/native/ring.cpp)
        from glava_tpu_torch import native

        planes = native.rgba_to_yuv444(frame)
        if planes is not None:
            for plane in planes:
                self.fh.write(plane.tobytes())
            return
        img = frame[::-1]  # top-down
        r = img[..., 0].astype(np.float32)
        g = img[..., 1].astype(np.float32)
        b = img[..., 2].astype(np.float32)
        yp = 0.299 * r + 0.587 * g + 0.114 * b
        u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
        v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
        for plane in (yp, u, v):
            self.fh.write(np.clip(plane, 0, 255).astype(np.uint8).tobytes())

    def close(self):
        self.fh.flush()


def write_png(path: str | Path, frame: np.ndarray) -> None:
    """Minimal PNG writer (RGBA8). `frame` is bottom-up GL order."""
    img = frame[::-1]
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(t: bytes, d: bytes) -> bytes:
        c = t + d
        return struct.pack(">I", len(d)) + c + struct.pack(">I", zlib.crc32(c))

    data = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(data)


def read_png(path: str | Path) -> np.ndarray:
    """Minimal PNG reader: 8-bit RGB/RGBA/gray, non-interlaced.

    Returns (H, W, 4) uint8, top-down row order. Covers the wallpaper
    images used as the xroot composite source (renderer.py) and
    round-trips :func:`write_png` output.
    """
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    w = h = None
    bit_depth = color_type = interlace = None
    idat = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            w, h, bit_depth, color_type, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if w is None:
        raise ValueError(f"{path}: missing IHDR")
    if bit_depth != 8 or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced PNGs supported "
            f"(depth={bit_depth}, interlace={interlace})"
        )
    nchan = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type)
    if nchan is None:
        raise ValueError(f"{path}: unsupported color type {color_type}")
    raw = zlib.decompress(b"".join(idat))
    stride = w * nchan
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG data")
    # scanline unfiltering: native C++ when buildable (the per-byte
    # Sub/Average/Paeth recurrences are pathological in Python at
    # wallpaper sizes), Python fallback otherwise
    from glava_tpu_torch import native

    out = native.png_unfilter(raw, h, stride, nchan)
    if out is not None:
        return _expand_rgba(out.reshape(h, w, nchan), nchan)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if ftype == 1:    # Sub
            for i in range(nchan, stride):
                row[i] = (int(row[i]) + int(row[i - nchan])) & 0xFF
        elif ftype == 2:  # Up
            row = ((row.astype(np.int32) + prev) & 0xFF).astype(np.uint8)
        elif ftype == 3:  # Average
            for i in range(stride):
                a = int(row[i - nchan]) if i >= nchan else 0
                row[i] = (int(row[i]) + ((a + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = int(row[i - nchan]) if i >= nchan else 0
                b = int(prev[i])
                c = int(prev[i - nchan]) if i >= nchan else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (int(row[i]) + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"{path}: unknown filter {ftype}")
        out[y] = row
        prev = row
    return _expand_rgba(out.reshape(h, w, nchan), nchan)


def _expand_rgba(px: np.ndarray, nchan: int) -> np.ndarray:
    h, w = px.shape[:2]
    rgba = np.empty((h, w, 4), np.uint8)
    if nchan == 1:
        rgba[..., :3] = px
        rgba[..., 3] = 255
    elif nchan == 2:
        rgba[..., :3] = px[..., :1]
        rgba[..., 3] = px[..., 1]
    elif nchan == 3:
        rgba[..., :3] = px
        rgba[..., 3] = 255
    else:
        rgba[...] = px
    return rgba


class PngSink(FrameSink):
    name = "png"

    def __init__(self, path: str | Path, every: int = 0):
        self.path = Path(path)
        self.every = every  # 0: keep overwriting; N: numbered every N frames
        self._n = 0

    def submit(self, frame, time_s):
        self._n += 1
        if self.every:
            if self._n % self.every:
                return
            target = self.path.with_name(f"{self.path.stem}_{self._n:06d}.png")
        else:
            target = self.path
        write_png(target, frame)


class ShmSink(FrameSink):
    """Shared-memory frame stream for external consumers.

    The cross-process analogue of the reference's GLX share-list
    texture steal (glava-obs/entry.c:156-168): a memory-mapped file
    with a small seqlock header + the newest frame; a consumer in any
    language maps it and reads torn-free frames.

    Layout (little-endian u32): magic 'GTFS', width, height, seq,
    frame_count, then H*W*4 bytes RGBA (bottom-up). seq is odd while a
    write is in progress.
    """

    name = "shm"
    MAGIC = 0x47544653

    def __init__(self, path: str):
        import mmap

        self.path = path
        self._mmap_mod = mmap
        self._map = None
        self._fh = None
        self._shape = None
        self._seq = 0
        self._count = 0

    def _ensure(self, h: int, w: int) -> None:
        if self._shape == (h, w):
            return
        if self._map is not None:
            self._map.close()
            self._fh.close()
        size = 20 + h * w * 4
        self._fh = open(self.path, "w+b")
        self._fh.truncate(size)
        self._map = self._mmap_mod.mmap(self._fh.fileno(), size)
        self._shape = (h, w)
        self._map[0:16] = struct.pack("<IIII", self.MAGIC, w, h, 0)

    def submit(self, frame, time_s):
        h, w = frame.shape[:2]
        self._ensure(h, w)
        self._seq += 1  # odd: write in progress
        self._map[12:16] = struct.pack("<I", self._seq)
        self._map[20:] = frame.tobytes()
        self._count += 1
        self._seq += 1  # even: published
        self._map[12:20] = struct.pack("<II", self._seq, self._count)

    def close(self):
        if self._map is not None:
            self._map.flush()
            self._map.close()
            self._fh.close()
            self._map = None


def read_shm_frame(path: str) -> np.ndarray | None:
    """Consumer helper: torn-free read of the newest ShmSink frame."""
    import mmap

    with open(path, "rb") as fh:
        m = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            magic, w, h = struct.unpack("<III", m[0:12])
            if magic != ShmSink.MAGIC:
                return None
            for _ in range(1000):
                (s0,) = struct.unpack("<I", m[12:16])
                if s0 & 1:
                    continue
                buf = np.frombuffer(m[20 : 20 + h * w * 4], dtype=np.uint8)
                (s1,) = struct.unpack("<I", m[12:16])
                if s0 == s1:
                    return buf.reshape(h, w, 4).copy()
            return None
        finally:
            m.close()


class WindowSink(FrameSink):
    """Live display window: pipe the y4m stream into a video player.

    GLava's core UX is "run it and see the visualizer"
    (glx_wcb.c:358, README.md:4). With compute decoupled from
    presentation, the live view is a player process consuming the
    YUV4MPEG2 stream on stdin — zero new dependencies when ``ffplay``
    or ``mpv`` is installed. Closing the player window ends the stream:
    ``should_close()`` goes true and the engine exits its frame loop,
    matching the reference's window-close semantics
    (glx_wcb.c:319-333).

    ``player`` may be a known name ("ffplay", "mpv", "ffmpeg"), a full
    command string (shlex-split; the y4m stream arrives on stdin), or
    empty to auto-pick. Override via the ``GLAVA_TPU_PLAYER`` env var.
    """

    name = "window"

    _KNOWN = {
        "ffplay": ["ffplay", "-loglevel", "error", "-window_title",
                   "GLava (glava_tpu)", "-f", "yuv4mpegpipe", "-i", "-"],
        "mpv": ["mpv", "--really-quiet", "--title=GLava (glava_tpu)",
                "--profile=low-latency", "--untimed", "-"],
        "ffmpeg": ["ffmpeg", "-loglevel", "error", "-f", "yuv4mpegpipe",
                   "-i", "-", "-f", "sdl", "GLava (glava_tpu)"],
    }

    def __init__(self, player: str = "", fps: int = 60):
        import os
        import shlex
        import shutil
        import subprocess

        player = player or os.environ.get("GLAVA_TPU_PLAYER", "")
        if player in self._KNOWN:
            cmd = self._KNOWN[player]
        elif player:
            cmd = shlex.split(player)
        else:
            for name in ("ffplay", "mpv", "ffmpeg"):
                if shutil.which(name):
                    cmd = self._KNOWN[name]
                    break
            else:
                raise RuntimeError(
                    "no video player found for --sink window: install "
                    "ffplay (ffmpeg) or mpv, pass window:<command>, or "
                    "set GLAVA_TPU_PLAYER"
                )
        if shutil.which(cmd[0]) is None:
            raise RuntimeError(f"player '{cmd[0]}' not found in PATH")
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        self._y4m = Y4MSink(self.proc.stdin, fps=fps)
        self._closed = False

    @property
    def wire_format(self) -> str:
        return self._y4m.wire_format

    def submit(self, frame, time_s):
        if self._closed:
            return
        try:
            self._y4m.submit(frame, time_s)
        except (BrokenPipeError, OSError):
            self._closed = True  # player window was closed

    def should_close(self) -> bool:
        return self._closed or self.proc.poll() is not None

    def close(self):
        if not self._closed:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            self._closed = True
        try:
            self.proc.wait(timeout=2.0)
        except Exception:
            self.proc.terminate()


class AsyncSink(FrameSink):
    """Decouple a slow consumer from the render loop.

    Frames are handed to a writer thread through a small latest-wins
    queue: when the consumer can't keep up (blocked pipe, slow disk)
    the OLDEST pending frame is dropped and rendering never stalls —
    the serving analogue of the reference's mailbox-style swap (the
    renderer never blocks on a slow compositor). Wrap any sink:
    ``--sink async:y4m:out.y4m``.
    """

    name = "async"

    def __init__(self, inner: FrameSink, depth: int = 2):
        self.inner = inner
        self._q: _queue.Queue = _queue.Queue(maxsize=max(depth, 1))
        self.dropped = 0
        self._stop = False
        self._exc: BaseException | None = None
        self._t = threading.Thread(target=self._writer, daemon=True,
                                   name="sink-writer")
        self._t.start()

    def _writer(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self.inner.submit(*item)
            except BaseException as e:  # surfaced via should_close
                self._exc = e
                return

    def submit(self, frame, time_s):
        if self._exc is not None:
            # fail fast on the render thread, like the unwrapped sink
            # would have (the writer already died on this error)
            raise RuntimeError(
                f"async sink consumer failed: {self._exc}"
            ) from self._exc
        if self._stop:
            return
        while True:
            try:
                self._q.put_nowait((frame, time_s))
                return
            except _queue.Full:
                try:
                    old = self._q.get_nowait()
                except _queue.Empty:
                    continue
                if old is None:
                    # raced with close(): restore the shutdown sentinel
                    # and drop THIS frame instead
                    self._q.put_nowait(None)
                    self.dropped += 1
                    return
                self.dropped += 1  # dropped the oldest pending frame

    def should_render(self) -> bool:
        return self.inner.should_render()

    def should_close(self) -> bool:
        return self._exc is not None or self.inner.should_close()

    def wait(self, timeout: float | None = None):
        """Delegate to a wrapped LatestFrameSink (embedding handle)."""
        if not hasattr(self.inner, "wait"):
            raise RuntimeError("wait() needs a latest-frame inner sink")
        return self.inner.wait(timeout)

    def latest(self):
        return self.inner.latest() if hasattr(self.inner, "latest") else None

    def close(self):
        self._stop = True
        if self._t.is_alive():
            try:
                self._q.put(None, timeout=5.0)
            except _queue.Full:
                pass  # writer died; nothing is draining
        self._t.join(timeout=10.0)
        if self._t.is_alive():
            # consumer is wedged inside inner.submit(); closing inner
            # under it would corrupt the stream — leave it to process
            # teardown (daemon thread) and say so
            import sys

            print("async sink: consumer did not drain within 10s; "
                  "leaving it to process teardown", file=sys.stderr)
            return
        self.inner.close()


class CallbackSink(FrameSink):
    name = "callback"

    def __init__(self, fn: Callable[[np.ndarray, float], None]):
        self.fn = fn

    def submit(self, frame, time_s):
        self.fn(frame, time_s)


def make_sink(spec: str, fps: float = 60) -> FrameSink:
    """Parse a sink spec: null | latest | raw[:path] | y4m[:path] |
    png:path | shm[:path] | window[:player] | async:<spec>."""
    kind, _, arg = spec.partition(":")
    if kind == "async":
        return AsyncSink(make_sink(arg or "latest", fps=fps))
    if kind == "null":
        return NullSink()
    if kind == "latest":
        return LatestFrameSink()
    if kind == "raw":
        import sys
        fh = open(arg, "wb") if arg and arg != "-" else sys.stdout.buffer
        return RawSink(fh)
    if kind == "y4m":
        import sys
        fh = open(arg, "wb") if arg and arg != "-" else sys.stdout.buffer
        return Y4MSink(fh, fps=fps)
    if kind == "png":
        return PngSink(arg or "frame.png")
    if kind == "shm":
        return ShmSink(arg or "/dev/shm/glava_tpu_frame")
    if kind == "window":
        return WindowSink(arg, fps=fps)
    raise ValueError(f"unknown sink '{spec}'")

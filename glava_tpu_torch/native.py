"""ctypes bindings for the native host runtime (ring + FIFO reader).

The C++ source is the JAX package's ``glava_tpu/native/ring.cpp``,
read by path as the shipped shaders are: importing ``glava_tpu`` would
pull in jax. It builds on first use with the JAX package's Makefile
flags into ``build/glava_tpu_torch/`` at the root of the checkout,
named by a hash of the source and the flags, never into
``glava_tpu/native/``. Callers fall back to the pure-Python ring when
no C++ toolchain is present: this is host capture, not the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "glava_tpu" / "native" / "ring.cpp"
BUILD_DIR = ROOT / "build" / "glava_tpu_torch"
# glava_tpu/native/Makefile: CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-lpthread")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _target() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXXFLAGS + LDFLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libglava_ring_{digest}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise FileNotFoundError("no C++ compiler (g++ or c++) on the PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXXFLAGS, str(SOURCE), "-o", tmp, *LDFLAGS],
                       check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            out = _target()
            if not out.is_file():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            _build_error = getattr(e, "stderr", None) or str(e)
            return None
        lib.gt_ring_new.restype = ctypes.c_void_p
        lib.gt_ring_new.argtypes = [ctypes.c_size_t]
        lib.gt_ring_free.argtypes = [ctypes.c_void_p]
        lib.gt_ring_push.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ]
        lib.gt_ring_push_mono.argtypes = lib.gt_ring_push.argtypes
        lib.gt_ring_snapshot.restype = ctypes.c_uint64
        lib.gt_ring_snapshot.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.gt_ring_updates.restype = ctypes.c_uint64
        lib.gt_ring_updates.argtypes = [ctypes.c_void_p]
        lib.gt_fifo_start.restype = ctypes.c_void_p
        lib.gt_fifo_start.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_float,
        ]
        lib.gt_fifo_running.restype = ctypes.c_int
        lib.gt_fifo_running.argtypes = [ctypes.c_void_p]
        lib.gt_fifo_stop.argtypes = [ctypes.c_void_p]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.gt_rgba_to_yuv444.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_size_t, u8p, u8p, u8p,
        ]
        lib.gt_png_unfilter.restype = ctypes.c_int
        lib.gt_png_unfilter.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t, u8p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeRing:
    """Seqlock stereo history ring (see ring.cpp)."""

    def __init__(self, bufsize: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native ring unavailable: {_build_error}")
        self._lib = lib
        self.bufsize = bufsize
        self._h = ctypes.c_void_p(lib.gt_ring_new(bufsize))
        self._snap = np.zeros((2, bufsize), np.float32)
        self._last_updates = 0

    def push(self, left: np.ndarray, right: np.ndarray, mono: bool = False) -> None:
        left = np.ascontiguousarray(left, np.float32)
        right = np.ascontiguousarray(right, np.float32)
        fn = self._lib.gt_ring_push_mono if mono else self._lib.gt_ring_push
        fn(self._h, _fptr(left), _fptr(right), len(left))

    def snapshot(self) -> tuple[np.ndarray, bool]:
        """(buffer copy, modified since last snapshot)."""
        upd = self._lib.gt_ring_snapshot(
            self._h, _fptr(self._snap[0]), _fptr(self._snap[1])
        )
        modified = upd != self._last_updates
        self._last_updates = upd
        return self._snap.copy(), modified

    @property
    def updates(self) -> int:
        return int(self._lib.gt_ring_updates(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.gt_ring_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def rgba_to_yuv444(frame: np.ndarray) -> tuple[np.ndarray, ...] | None:
    """Native RGBA8 (bottom-up) -> planar YUV444 (top-down) for the y4m
    sink; None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    h, w = frame.shape[:2]
    frame = np.ascontiguousarray(frame, np.uint8)
    y = np.empty((h, w), np.uint8)
    u = np.empty((h, w), np.uint8)
    v = np.empty((h, w), np.uint8)
    lib.gt_rgba_to_yuv444(_u8ptr(frame), w, h, _u8ptr(y), _u8ptr(u), _u8ptr(v))
    return y, u, v


class NativeFifoReader:
    """Native capture thread reading s16le stereo from a FIFO."""

    def __init__(self, ring: NativeRing, path: str, hop: int,
                 mono: bool = False, scale: float = 1.0 / 65535.0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native ring unavailable: {_build_error}")
        self._lib = lib
        self._ring = ring  # keep the ring alive while the thread runs
        self._h = ctypes.c_void_p(
            lib.gt_fifo_start(ring._h, path.encode(), hop, int(mono),
                              ctypes.c_float(scale))
        )
        if not self._h:
            raise RuntimeError("failed to start native FIFO reader")

    def running(self) -> int:
        return self._lib.gt_fifo_running(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.gt_fifo_stop(self._h)
            self._h = None
            self._ring = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def png_unfilter(raw: bytes, h: int, stride: int,
                 nchan: int) -> np.ndarray | None:
    """Native PNG scanline unfiltering (RFC 2083 filters 0-4); None
    when the native lib is unavailable. Returns (h, stride) uint8."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(np.frombuffer(raw, np.uint8, h * (stride + 1)))
    out = np.empty((h, stride), np.uint8)
    rc = lib.gt_png_unfilter(_u8ptr(src), h, stride, nchan, _u8ptr(out))
    if rc != 0:
        raise ValueError(f"unknown PNG filter {rc}")
    return out

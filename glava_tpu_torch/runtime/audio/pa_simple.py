"""ctypes binding for the PulseAudio simple API (record direction).

The reference capture thread blocks on ``pa_simple_read`` of float32
native-endian interleaved stereo with ``fragsize = sample_sz`` bytes
(pulse_input.c:115-149); this module reproduces that exact stream
configuration against ``libpulse-simple.so`` via ctypes — no compiled
extension and no subprocess. The ``lib`` parameter is injectable so a
fake libpulse can drive unit tests without a PulseAudio daemon
(tests/test_torch_engine.py).
"""

from __future__ import annotations

import ctypes
import sys
from ctypes import POINTER, byref, c_char_p, c_int, c_size_t, c_uint8, \
    c_uint32, c_void_p

import numpy as np

# enum pa_sample_format (pulse/sample.h)
PA_SAMPLE_FLOAT32LE = 5
PA_SAMPLE_FLOAT32BE = 6
FSAMPLE_FORMAT = (
    PA_SAMPLE_FLOAT32LE if sys.byteorder == "little" else PA_SAMPLE_FLOAT32BE
)
# enum pa_stream_direction (pulse/def.h)
PA_STREAM_RECORD = 2

_UINT32_MAX = 0xFFFFFFFF


class pa_sample_spec(ctypes.Structure):
    _fields_ = [
        ("format", c_int),
        ("rate", c_uint32),
        ("channels", c_uint8),
    ]


class pa_buffer_attr(ctypes.Structure):
    _fields_ = [
        ("maxlength", c_uint32),
        ("tlength", c_uint32),
        ("prebuf", c_uint32),
        ("minreq", c_uint32),
        ("fragsize", c_uint32),
    ]


def load_libpulse():
    """dlopen libpulse-simple, or None when PulseAudio isn't installed."""
    for name in ("libpulse-simple.so.0", "libpulse-simple.so",
                 "libpulse-simple.dylib"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def _configure(lib) -> None:
    """Set ctypes prototypes (skipped for injected fakes)."""
    if not isinstance(lib, ctypes.CDLL):
        return
    lib.pa_simple_new.restype = c_void_p
    lib.pa_simple_new.argtypes = [
        c_char_p, c_char_p, c_int, c_char_p, c_char_p,
        POINTER(pa_sample_spec), c_void_p, POINTER(pa_buffer_attr),
        POINTER(c_int),
    ]
    lib.pa_simple_read.restype = c_int
    lib.pa_simple_read.argtypes = [c_void_p, c_void_p, c_size_t,
                                   POINTER(c_int)]
    lib.pa_simple_free.restype = None
    lib.pa_simple_free.argtypes = [c_void_p]
    lib.pa_strerror.restype = c_char_p
    lib.pa_strerror.argtypes = [c_int]


def _strerror(lib, code: int) -> str:
    try:
        msg = lib.pa_strerror(c_int(code))
        if isinstance(msg, bytes):
            return msg.decode(errors="replace")
        return str(msg)
    except Exception:  # pragma: no cover - fake libs without pa_strerror
        return f"error {code}"


class PaSimpleCapture:
    """A blocking pa_simple RECORD stream, reference-configured.

    Stream parameters match pulse_input.c:114-123: float32ne stereo at
    ``rate``, ``fragsize = sample_sz`` bytes, maxlength unset (-1); each
    :meth:`read` returns ``sample_sz / 2`` interleaved float samples
    (``float buf[ssz / 2]``, pulse_input.c:112,146).
    """

    def __init__(self, source: str, rate: int, sample_sz: int,
                 lib=None, app_name: bytes = b"glava"):
        self.lib = lib if lib is not None else load_libpulse()
        if self.lib is None:
            raise RuntimeError(
                "libpulse-simple not found — native PulseAudio capture "
                "unavailable"
            )
        _configure(self.lib)
        self._ss = pa_sample_spec(FSAMPLE_FORMAT, rate, 2)
        self._pb = pa_buffer_attr(
            maxlength=_UINT32_MAX, tlength=_UINT32_MAX, prebuf=_UINT32_MAX,
            minreq=_UINT32_MAX, fragsize=sample_sz,
        )
        err = c_int(0)
        self._s = self.lib.pa_simple_new(
            None, app_name, PA_STREAM_RECORD,
            source.encode() if isinstance(source, str) else source,
            b"audio for glava",
            byref(self._ss), None, byref(self._pb), byref(err),
        )
        if not self._s:
            raise RuntimeError(
                f"Could not open pulseaudio source: {source}, "
                f"{_strerror(self.lib, err.value)}. To find a list of your "
                "pulseaudio sources run 'pacmd list-sources'"
            )
        self._nbytes = sample_sz * 2          # ssz/2 floats
        self._buf = (ctypes.c_char * self._nbytes)()

    def read(self) -> np.ndarray:
        """Block for one fragment; (sample_sz/2,) interleaved float32."""
        err = c_int(0)
        rc = self.lib.pa_simple_read(
            self._s, self._buf, c_size_t(self._nbytes), byref(err)
        )
        if rc < 0:
            raise RuntimeError(
                f"pa_simple_read() failed: {_strerror(self.lib, err.value)}"
            )
        return np.frombuffer(bytes(self._buf), dtype=np.float32)

    def close(self) -> None:
        if getattr(self, "_s", None):
            self.lib.pa_simple_free(self._s)
            self._s = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

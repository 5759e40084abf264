"""The bars raster: per-column bar heights -> (S, 4, H, W) channel planes.

The raster stage of the bars pass (``render/modules/bars.py``, after
the per-column spectrum sample), the port's counterpart of the TPU
kernel ``scripts/exp_pallas_bars.py:pallas_raster``, with a leading
stream axis so that a fleet rasterizes in one launch:

* ``v``       (S, W) float32  amplified bar height a column, -inf at gap
  and out-of-range columns;
* ``inner``   (W,) bool       the column lies inside a bar's outline;
* ``d``       (H,) float32    each row's distance from the baseline;
* ``color``   (S or 1, H, 4)  fill colour a row (``COLOR``);
* ``outline`` (S or 1, H, 4)  outline colour a row (``BAR_OUTLINE``);
* ``bow``     the outline width; ``outlined`` is ``bow > 0`` in the
  bars pass: without an outline only the body draws (bars.py's
  ``BAR_OUTLINE_WIDTH 0`` branch).

:func:`bars_raster_plain` is the plain torch version.
:func:`bars_raster` takes it for CPU tensors and launches the CUDA
kernel (``csrc/bars_raster.cu``) for CUDA tensors; it never falls back
from one to the other. Comparisons and selects only, so the two agree
bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# kernel launches made by bars_raster (CUDA tensors only)
launches = 0

MAX_STREAMS = 65535     # the kernel's grid depth


def bars_raster_plain(v, inner, d, color, outline, bow: float,
                      outlined: bool) -> torch.Tensor:
    """The three disjoint masks of the bars pass, broadcast over the
    streams -> (S, 4, H, W) float32."""
    bow = float(np.float32(bow))        # v - bow in float32
    vv = v[:, None, :]                                  # (S, 1, W)
    dd = d[:, None]                                     # (H, 1)
    body = dd < vv - bow                                # (S, H, W)
    fill_c = color.permute(0, 2, 1)[..., None]          # (S|1, 4, H, 1)
    if not outlined:
        return torch.where(body[:, None], fill_c, 0.0)
    rim_c = outline.permute(0, 2, 1)[..., None]
    edge = dd <= vv
    fill = body & inner
    rim = (edge & ~body) | (body & ~inner)
    out = torch.where(rim[:, None], rim_c, 0.0)
    return torch.where(fill[:, None], fill_c, out)


def bars_raster(v, inner, d, color, outline, bow: float,
                outlined: bool) -> torch.Tensor:
    """:func:`bars_raster_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors, which raises when the inputs are not what it takes
    (contiguous tensors of the shapes and types above, on one card)."""
    if v.device.type == "cpu":
        return bars_raster_plain(v, inner, d, color, outline, bow, outlined)
    if v.device.type != "cuda":
        raise ValueError(f"bars_raster: unsupported device {v.device}")
    return _launch(v, inner, d, color, outline, bow, outlined)


def _check(name, t, dtype, device, ndim):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"bars_raster: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"bars_raster: {name} is on {t.device}, v on {device}")
    if t.dtype != dtype:
        raise TypeError(f"bars_raster: {name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"bars_raster: {name} must have {ndim} dimensions, "
                         f"got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"bars_raster: {name} must be contiguous")


_FN = None


def _kernel():
    """The built kernel's C entry point, resolved once."""
    global _FN
    if _FN is None:
        from glava_tpu_torch.ops import _build

        fn = _build.load("bars_raster").lib.glava_bars_raster
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(v, inner, d, color, outline, bow, outlined):
    global launches
    dev = v.device
    f32 = torch.float32
    _check("v", v, f32, dev, 2)
    _check("inner", inner, torch.bool, dev, 1)
    _check("d", d, f32, dev, 1)
    _check("color", color, f32, dev, 3)
    _check("outline", outline, f32, dev, 3)
    S, W = v.shape
    H = d.shape[0]
    if not 1 <= S <= MAX_STREAMS or min(H, W) < 1:
        raise ValueError(f"bars_raster: needs 1 <= S <= {MAX_STREAMS} streams "
                         f"and a non-empty frame, got S {S}, H {H}, W {W}")
    if inner.shape[0] != W:
        raise ValueError(f"bars_raster: inner has {inner.shape[0]} columns, "
                         f"v {W}")
    strides = []
    for name, t in (("color", color), ("outline", outline)):
        if t.shape[0] not in (1, S) or tuple(t.shape[1:]) != (H, 4):
            raise ValueError(f"bars_raster: {name} has shape {tuple(t.shape)}, "
                             f"expected ({S} or 1, {H}, 4)")
        strides.append(0 if t.shape[0] == 1 else H * 4)
    out = torch.empty((S, 4, H, W), dtype=f32, device=dev)

    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(v.data_ptr(), inner.data_ptr(), d.data_ptr(), color.data_ptr(),
                 outline.data_ptr(), out.data_ptr(), S, H, W, strides[0],
                 strides[1], float(np.float32(bow)), int(bool(outlined)), stream)
    if err != 0:
        raise RuntimeError(f"bars_raster kernel launch failed: CUDA error {err}")
    launches += 1
    return out

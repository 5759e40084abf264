"""The ``smooth`` transform: a log-scale neighbourhood average of the
leading ``ceil(sz / ratio)`` bins, SEQUENTIAL and IN PLACE, as the
reference runs it (glava/render.c:694-718) and as the JAX package
writes it (``glava_tpu/ops/transforms.py:smooth_transform``, a
``lax.scan`` over the bins).

Bin ``t`` becomes the mean of the nonzero entries of the window
``[floor(e^max(ln t - d, 0)), min(ceil(e^(ln t + d)), sz - 1)]`` of the
buffer as it stands: entries below ``t`` already smoothed, the others
not. Its rules, kept as they are (ROADMAP queue 3): zero entries are
skipped; a NaN entry passes the nonzero check and poisons every window
that holds it; a window with no nonzero entry gives 0/0 = NaN (row 0
always does); at the end NaN maps to 0 and +-inf pass through.

* :func:`smooth_transform_plain` is the plain torch version, the JAX
  ``step`` over each bin's window with ``where``-masking;
* :func:`smooth_transform` takes it for CPU tensors and launches the
  CUDA kernel (``csrc/smooth_scan.cu``) for CUDA tensors; it never falls
  back from one to the other. The kernel walks a row on its fast walk
  (each window's count and divisor found before the walk) until a bin
  comes out exactly 0 or a window holds an input +-inf, and the rest of
  the row on its exact walk; :func:`rows_by_walk` counts the rows each
  walk finished.

The kernel is not the port of a Pallas kernel: it is the counterpart of
the ``lax.scan`` at ``glava_tpu/ops/transforms.py:145``, which runs on
the device as one program, where the eager loop would issue some five
launches a bin (5 x 1024 a frame at the default ``sz/ratio`` 4096/4).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from glava_tpu_torch.ops._build import SMEM_LIMIT

# kernel launches made by smooth_transform (CUDA tensors only)
launches = 0

MAX_ROWS = 2 ** 31 - 1          # the kernel's grid
# bytes of the kernel's tables in shared memory, the kernel's own static
# shared memory (its block scan) left aside; larger tables live in a
# device scratch buffer
STAGED_MAX = SMEM_LIMIT - 1024

_BOUNDS: dict[tuple, tuple[torch.Tensor, bool]] = {}
# per device: int64 (2,), the rows the kernel's fast walk finished and
# those its exact walk finished, added to on the device
_ROWS: dict[torch.device, torch.Tensor] = {}


def table_bytes(sz: int, asz: int) -> int:
    """Bytes of one row's tables (the kernel's
    ``glava_smooth_scan_bytes``, a multiple of 16): the smoothed bins in
    float32, then the larger of the fast walk's tables (32 bytes of
    operands a bin, the input's prefix, over which the chain's values
    and their prefix lie later) and the exact walk's prefix statistics
    (24 bytes an entry, sz + asz + 2)."""
    bins = -(-4 * asz // 16) * 16
    fast = 32 * asz + 16 * (sz + 1)
    return -(-(bins + max(fast, 24 * (sz + asz + 2))) // 16) * 16


def rows_by_walk() -> dict[str, int]:
    """The rows the kernel's fast walk and its exact walk finished since
    :func:`reset_rows_by_walk`, over every device (reads the device
    counters: one synchronize each)."""
    fast = exact = 0
    for counts in _ROWS.values():
        f, e = counts.tolist()
        fast, exact = fast + f, exact + e
    return {"fast": fast, "exact": exact}


def reset_rows_by_walk() -> None:
    for counts in _ROWS.values():
        counts.zero_()


@functools.lru_cache(maxsize=None)
def smooth_bounds(sz: int, ratio: float, distance: float) -> np.ndarray:
    """int32 (asz, 2): each bin's inclusive window ``[lo, hi]``, the rows
    of the JAX package's ``_smooth_mask`` computed the same way (float64,
    one bin at a time). Row 0 is empty, ``[1, 0]`` (log 0 = -inf)."""
    asz = int(np.ceil(sz / ratio))
    out = np.zeros((asz, 2), np.int32)
    if asz:
        out[0] = (1, 0)
    for t in range(1, asz):
        db = np.log(float(t))
        out[t, 0] = int(np.floor(np.exp(max(db - distance, 0.0))))
        out[t, 1] = min(int(np.ceil(np.exp(db + distance))), sz - 1)
    return out


def smooth_transform_plain(x: torch.Tensor, ratio: float,
                           distance: float) -> torch.Tensor:
    """(..., sz) float32 -> (..., sz) float32: the JAX ``step`` of each
    bin in turn on a copy of ``x``, the window's mask row applied as a
    slice (entries outside it are 0 in the mask, so they add nothing)."""
    buf = x.to(torch.float32).clone()
    for t, (lo, hi) in enumerate(smooth_bounds(x.shape[-1], float(ratio),
                                               float(distance)).tolist()):
        win = buf[..., lo:hi + 1]
        # where, not a product: a carried NaN poisons only the windows
        # that hold it; NaN != 0 counts it, as the C nonzero check does
        hit = win != 0.0
        num = torch.where(hit, win, 0.0).sum(dim=-1)
        den = hit.sum(dim=-1).to(torch.float32)
        buf[..., t] = num / den              # 0/0 -> NaN, as the reference
    return torch.nan_to_num(buf, nan=0.0, posinf=float("inf"),
                            neginf=float("-inf"))


def smooth_transform(x: torch.Tensor, ratio: float,
                     distance: float) -> torch.Tensor:
    """:func:`smooth_transform_plain` on CPU tensors; the CUDA kernel on
    CUDA tensors, which raises when the input is not a float32 tensor
    whose bins' windows it can walk in order."""
    if x.device.type == "cpu":
        return smooth_transform_plain(x, ratio, distance)
    if x.device.type != "cuda":
        raise ValueError(f"smooth_transform: unsupported device {x.device}")
    return _launch(x, float(ratio), float(distance))


def _bounds(sz: int, ratio: float, distance: float,
            device) -> tuple[torch.Tensor, bool]:
    """:func:`smooth_bounds` on ``device``, checked once: the kernel
    takes each bin's window as ``0 <= lo <= t <= hi < sz``; and whether
    its fast walk may take them: lo grows by 0 or 1 a bin (it drops
    each bin from its running window sum once, in order), which holds
    for every distance above ~1e-15."""
    key = (sz, ratio, distance, device)
    if key not in _BOUNDS:
        b = smooth_bounds(sz, ratio, distance)
        t = np.arange(1, len(b))
        lo, hi = b[1:, 0], b[1:, 1]
        if np.any(lo < 0) or np.any(lo > t) or np.any(hi < t) or np.any(hi >= sz):
            raise ValueError(f"smooth_transform: windows of sz {sz}, ratio "
                             f"{ratio}, distance {distance} do not hold their "
                             "bins")
        step = np.diff(lo)
        _BOUNDS[key] = (torch.as_tensor(b, device=device),
                        bool(np.all((step == 0) | (step == 1))))
    return _BOUNDS[key]


_FN = None


def _kernel():
    """The built kernel's C entry point, resolved once."""
    global _FN
    if _FN is None:
        from glava_tpu_torch.ops import _build

        fn = _build.load("smooth_scan").lib.glava_smooth_scan
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(x: torch.Tensor, ratio: float, distance: float,
            exact_from: int | None = None) -> torch.Tensor:
    """The kernel on ``x``; ``exact_from`` hands every row to the exact
    walk at that bin at the latest (chip_smoke.py holds both walks
    against the plain version with it)."""
    global launches
    if x.dtype != torch.float32:
        raise TypeError(f"smooth_transform: input must be float32, got {x.dtype}")
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError(f"smooth_transform: input must be (..., sz) with "
                         f"sz >= 1, got {tuple(x.shape)}")
    sz = x.shape[-1]
    if not ratio > 0:
        raise ValueError(f"smooth_transform: ratio must be positive, got {ratio}")
    bounds, fast = _bounds(sz, ratio, distance, x.device)
    if bounds.shape[0] > sz:
        raise ValueError(f"smooth_transform: ratio {ratio} leaves "
                         f"{bounds.shape[0]} bins to smooth in a row of {sz}")
    rows = x.numel() // sz
    if rows > MAX_ROWS:
        raise ValueError(f"smooth_transform: at most {MAX_ROWS} rows, got {rows}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if rows == 0:
        return out
    asz = bounds.shape[0]
    table = table_bytes(sz, asz)
    staged = int(table <= STAGED_MAX)
    scratch = None if staged else torch.empty(
        rows * table, dtype=torch.uint8, device=x.device)
    if x.device not in _ROWS:
        _ROWS[x.device] = torch.zeros(2, dtype=torch.int64, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), bounds.data_ptr(), out.data_ptr(),
                 None if staged else scratch.data_ptr(),
                 _ROWS[x.device].data_ptr(), rows, sz, asz, staged,
                 (asz if fast else 1) if exact_from is None else int(exact_from),
                 stream)
    if err != 0:
        raise RuntimeError(f"smooth_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return out

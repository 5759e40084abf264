"""Table lookup: ``out = table[..., idx]`` from a small float32 table.

The port's counterpart of ``glava_tpu/ops/pallas/lookup.py``'s
``build_table_lookup`` and ``build_static_table_lookup`` (one function,
one kernel: ``csrc/table_lookup.cu``) and of the interpreter's texel
fetch ``_fetch_1d`` (``glava_tpu/config/glsl_shader.py``).

* :func:`table_lookup_plain` is the plain torch gather.
* :func:`table_lookup` takes it for CPU tensors and launches the CUDA
  kernel for CUDA tensors; it never falls back from one to the other.
* :class:`StaticLookup` holds an index plane fixed at build time on the
  device (the radial and circle rasters), checked once.
* :func:`fetch_1d` clips texel indices into a texture, then gathers.
* :func:`rowwise_lookup` gathers every row from its own table row, the
  counterpart of ``build_rowwise_lookup`` and
  ``build_rowwise_lookup_mc`` (kernel: ``csrc/rowwise_lookup.cu``, on
  the route :func:`rowwise_plan` picks from the shapes and strides):
  the interpreter's column-aligned texel fetch at a runtime row.

Every result is pure data movement, so each kernel and its plain
version agree bit for bit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from glava_tpu_torch.ops._build import SMEM_LIMIT

# kernel launches made by table_lookup (CUDA tensors only)
launches = 0

# each kernel's C entry point and its argument types
_ENTRIES = {
    "table_lookup": ("glava_table_lookup", [ctypes.c_void_p] * 3
                     + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_void_p]),
    "rowwise_lookup": ("glava_rowwise_lookup", [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
}
_FNS: dict = {}


def _kernel(name: str):
    """The built kernel's C entry point, resolved once."""
    if name not in _FNS:
        from glava_tpu_torch.ops import _build

        symbol, argtypes = _ENTRIES[name]
        fn = getattr(_build.load(name).lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]

MAX_TABLES = 65535        # the kernel's grid rows
MAX_TABLE = 48 * 1024     # entries a table row stages in shared memory;
                          # a longer one is read from the L2


def table_lookup_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx]``: a (T,) or (S, T) float32 table at integer
    indices of any shape -> (*S, *idx.shape) float32."""
    return table[..., idx]


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """:func:`table_lookup_plain` on CPU tensors; the CUDA kernel on
    CUDA tensors, which raises when the inputs are not what it takes
    (an int32 index tensor, a (T,) or (S, T) float32 table on the same
    card; staged in shared memory up to ``MAX_TABLE`` entries, read
    from the L2 above). Indices must lie in
    [0, T): the kernel does not check them (an index outside reads as
    NaN), the plain version raises."""
    if table.device.type == "cpu":
        return table_lookup_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"table_lookup: unsupported device {table.device}")
    return _launch(table, idx)


def _launch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global launches
    if table.dtype != torch.float32:
        raise TypeError(f"table_lookup: table must be float32, got {table.dtype}")
    if table.ndim not in (1, 2) or not 1 <= table.shape[-1] < 2 ** 31:
        raise ValueError(f"table_lookup: table must be (T,) or (S, T) with "
                         f"1 <= T < 2**31, got {tuple(table.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"table_lookup: indices must be int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"table_lookup: indices on {idx.device}, table on "
                         f"{table.device}")
    S = table.shape[0] if table.ndim == 2 else 1
    T = table.shape[-1]
    P = idx.numel()
    if S > MAX_TABLES:
        raise ValueError(f"table_lookup: at most {MAX_TABLES} tables, got {S}")
    out = torch.empty(tuple(table.shape[:-1]) + tuple(idx.shape),
                      dtype=torch.float32, device=table.device)
    if P == 0 or S == 0:
        return out
    table = table.contiguous()
    idx = idx.contiguous()

    fn = _kernel("table_lookup")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), S, T, P,
                 stream)
    if err != 0:
        raise RuntimeError(f"table_lookup kernel launch failed: CUDA error {err}")
    launches += 1
    return out


class StaticLookup:
    """``table -> table[..., idx]`` at an index plane fixed at build
    time: the role of ``build_static_table_lookup``. The numpy plane is
    checked once here (``0 <= idx < table_size``, the contract of the
    TPU kernel) and kept on ``device`` as int32; every call is one
    :func:`table_lookup`."""

    def __init__(self, idx_np, table_size: int, device):
        idx = np.asarray(idx_np)
        if not np.issubdtype(idx.dtype, np.integer):
            raise TypeError(f"StaticLookup: indices must be integers, got {idx.dtype}")
        if table_size < 1 or table_size > np.iinfo(np.int32).max:
            raise ValueError(f"StaticLookup: bad table size {table_size}")
        if idx.size and (idx.min() < 0 or idx.max() >= table_size):
            raise ValueError(
                f"StaticLookup: indices must lie in [0, {table_size}), got "
                f"[{idx.min()}, {idx.max()}]")
        self.table_size = int(table_size)
        self.idx = torch.as_tensor(idx.astype(np.int32), device=device)

    def __call__(self, table: torch.Tensor) -> torch.Tensor:
        if table.shape[-1] != self.table_size:
            raise ValueError(f"StaticLookup: table has {table.shape[-1]} "
                             f"entries, built for {self.table_size}")
        return table_lookup(table, self.idx)


def fetch_1d(tex: torch.Tensor, i: torch.Tensor, sz: int) -> torch.Tensor:
    """``tex[..., clip(i, 0, sz - 1)]``: the texel fetch of a (sz,)
    texture (``_fetch_1d``), through :func:`table_lookup`."""
    ic = torch.clamp(torch.as_tensor(i, device=tex.device), 0, sz - 1)
    return table_lookup(tex, ic.to(torch.int32))


# ---------------------------------------------------------------------------
# row-wise lookup: every row gathers from its own table row
# ---------------------------------------------------------------------------

ROWWISE_CHANNELS = (1, 4)
ROWWISE_ROUTES = ("staged", "direct")
ROWWISE_STRIPS = (16, 8)  # table rows a CTA may own, the widest first
ROWWISE_BAND = 256        # points a CTA covers on the direct route, at least
MAX_BANDS = 65535         # the kernel's grid rows

# kernel launches made by rowwise_lookup (CUDA tensors only), by C and
# by route
rowwise_launches = dict.fromkeys(ROWWISE_CHANNELS, 0)
rowwise_routes = dict.fromkeys(ROWWISE_ROUTES, 0)


@dataclass(frozen=True)
class RowwisePlan:
    """How ``csrc/rowwise_lookup.cu`` runs one call, from the shapes and
    strides alone: a CTA owns ``strip`` adjacent table rows; ``route``
    "staged" (a CTA stages its strip's index plane and, two at a time,
    its C tables in ``smem`` bytes of shared memory, and covers all P
    points) or "direct" (tables read from the L2, CTAs over bands of
    ``band`` points); ``i_fast``: neighbouring threads take neighbouring
    table rows i, as the index plane is laid out."""
    route: str
    i_fast: bool
    strip: int
    band: int
    smem: int


def rowwise_plan(C: int, T: int, P: int, idx_strides) -> RowwisePlan:
    """The kernel's plan for C tables of T entries and P points a row:
    staged on the widest strip whose index plane and min(C, 2) table
    buffers fit in shared memory, else direct. The one owner of the
    staged route's layout (``[strip x P]`` index, then the table
    buffers, float32): the kernel takes ``smem`` as given."""
    i_fast = idx_strides[0] < idx_strides[1]
    for strip in ROWWISE_STRIPS:
        smem = 4 * strip * (P + min(C, 2) * T)
        if smem <= SMEM_LIMIT:
            return RowwisePlan("staged", i_fast, strip, P, smem)
    return RowwisePlan("direct", i_fast, ROWWISE_STRIPS[0],
                       max(ROWWISE_BAND, -(-P // MAX_BANDS)), 0)


def rowwise_lookup_plain(tabs, idx: torch.Tensor) -> tuple:
    """``out[c][i, j] = tabs[c][i, idx[i, j]]`` with ``torch.gather``:
    tabs a tuple of C (N, T) float32, idx (N, P) integer in [0, T)
    (raises otherwise) -> a tuple of C (N, P) float32."""
    T = tabs[0].shape[1]
    il = idx.long()
    try:
        # the gather checks the range itself: no read of the indices on
        # the host unless one is out of it
        return tuple(torch.gather(t, 1, il) for t in tabs)
    except RuntimeError as e:
        raise ValueError(f"rowwise_lookup: indices must lie in [0, {T}), got "
                         f"[{int(idx.min())}, {int(idx.max())}]") from e


def rowwise_lookup(tabs, idx: torch.Tensor) -> tuple:
    """:func:`rowwise_lookup_plain` on CPU tensors; the CUDA kernel
    (``csrc/rowwise_lookup.cu``, the counterpart of the TPU kernels
    ``build_rowwise_lookup`` and ``build_rowwise_lookup_mc``) on CUDA
    tensors, which raises when the inputs are not what it takes. Every
    operand may be a strided view (``plane.T`` of an (H, W) plane): the
    kernel reads through the strides, and an output takes the layout of
    ``idx``. Indices must lie in [0, T): the kernel does not check them
    (one outside reads as NaN), the plain version raises."""
    tabs = tuple(tabs)
    if idx.device.type == "cpu":
        return rowwise_lookup_plain(tabs, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"rowwise_lookup: unsupported device {idx.device}")
    return _launch_rowwise(tabs, idx)


def _launch_rowwise(tabs, idx):
    C = len(tabs)
    if C not in ROWWISE_CHANNELS:
        raise ValueError(f"rowwise_lookup: C must be one of "
                         f"{ROWWISE_CHANNELS}, got {C}")
    if idx.dtype != torch.int32:
        raise TypeError(f"rowwise_lookup: indices must be int32, got {idx.dtype}")
    if idx.ndim != 2:
        raise ValueError(f"rowwise_lookup: idx must be (N, P), got "
                         f"{tuple(idx.shape)}")
    N, P = idx.shape
    shape = tabs[0].shape
    for c, t in enumerate(tabs):
        if t.dtype != torch.float32:
            raise TypeError(f"rowwise_lookup: tabs[{c}] must be float32, got "
                            f"{t.dtype}")
        if t.device != idx.device:
            raise ValueError(f"rowwise_lookup: tabs[{c}] on {t.device}, idx on "
                             f"{idx.device}")
        if t.ndim != 2 or t.shape[0] != N or t.shape != shape:
            raise ValueError(f"rowwise_lookup: tabs[{c}] has shape "
                             f"{tuple(t.shape)}, expected ({N}, T) like tabs[0]")
        if t.stride() != tabs[0].stride():
            raise ValueError("rowwise_lookup: the tables must share one layout")
    T = shape[1]
    if min(N, P, T) < 1:
        raise ValueError(f"rowwise_lookup: empty operand (N {N}, T {T}, P {P})")
    plan = rowwise_plan(C, T, P, idx.stride())
    # outputs take idx's layout: a transposed view stays transposed, so
    # the points that are neighbours in memory stay neighbours
    if plan.i_fast:
        outs = [torch.empty((P, N), dtype=torch.float32, device=idx.device).T
                for _ in tabs]
    else:
        outs = [torch.empty((N, P), dtype=torch.float32, device=idx.device)
                for _ in tabs]

    fn = _kernel("rowwise_lookup")
    tab_ptrs = (ctypes.c_void_p * C)(*[t.data_ptr() for t in tabs])
    out_ptrs = (ctypes.c_void_p * C)(*[o.data_ptr() for o in outs])
    ts, xs, os_ = tabs[0].stride(), idx.stride(), outs[0].stride()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = fn(tab_ptrs, idx.data_ptr(), out_ptrs, C, N, T, P,
                 ts[0], ts[1], xs[0], xs[1], os_[0], os_[1], int(plan.i_fast),
                 plan.strip, int(plan.route == "staged"), plan.band, plan.smem,
                 stream)
    if err != 0:
        raise RuntimeError(f"rowwise_lookup kernel launch failed: CUDA error {err}")
    rowwise_launches[C] += 1
    rowwise_routes[plan.route] += 1
    return tuple(outs)

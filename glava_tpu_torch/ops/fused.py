"""The fused spectrum update: FFT + magnitude + gravity + average.

One audio update of every fft uniform row, in the layout of the JAX
package's ``FusedChainState`` (glava_tpu/pipeline.py:72-91):

* ``pcm``   (B, n)        raw ring snapshots (not windowed)
* ``grav``  (B, 2, m)     gravity store planes (re, im), m = n/2
* ``hist``  (B, F, 2, m)  rolling average history, a ring
* ``slot``  (B,) int32    each row's ring slot to overwrite
* ``avg``   (B, 2, m)     the age-weighted average (the texture source)

``fft_scale``, ``fft_cutoff`` and ``g`` are per-row (B,) float32
vectors; ``window`` is ``windows.pcm_window(n)`` and ``age_weights``
the averaging weights in AGE order (:func:`age_weights`), both as
tensors on the rows' device.

:func:`fused_update_plain` is the plain torch version.
:func:`fused_update` runs it for CPU tensors and launches the CUDA
kernel (``csrc/fused_update.cu``, replacing the TPU kernel
``glava_tpu/ops/pallas/fused.py:build_fused_update_inc``) for CUDA
tensors; it never falls back from one to the other. Bufsizes below
the kernel's, and above its largest split plan (MAX_SPLIT_N), run
:func:`chain_update` on any device, chosen from the shape alone
(:func:`update_route`).

Up to n = MAX_N (65536) the kernel runs each row on a cluster of ``k``
CTAs that split its m-point FFT four-step wise; :func:`fft_plan` picks
``k``, the CTAs' FFT radices and (``FFTPlan.slots``) how much history
fits in shared memory, and :func:`twiddle_table` builds the float64
table the kernel copies in. Above MAX_N the plan is a split one
(``FFTPlan.split``): two launches through a float64 scratch tensor, the
column FFTs first, then, as their programmatic dependent, the k-point
stage and the epilogue, whose history is copied into shared memory
while the column FFTs run (:data:`split_launches` counts the pairs).
The CPU tests read the plans to check both splits' index mappings and
where the epilogue finds each prefetched float.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from glava_tpu_torch.ops import fft
from glava_tpu_torch.ops._build import SMEM_LIMIT

# kernel launches made by fused_update (CUDA tensors only): the
# one-cluster kernel (n up to MAX_N), and the split route above it
launches = 0
split_launches = 0

PORTABLE_CLUSTER = 8     # CTAs a cluster may hold on any card
MAX_CLUSTER = 16         # ... on an H100, with the non-portable opt-in
MAX_CTA_POINTS = 2048    # one CTA's FFT: 88 bytes of shared memory a point
# the one-cluster plans' sizes; above MAX_N the split plans, up to
# MAX_SPLIT_N, where the k-point stage's 4096 columns fill a CTA
MIN_N, MAX_N = 256, 2 * MAX_CLUSTER * MAX_CTA_POINTS
MAX_SPLIT_N = 1 << 24
SPLIT_COLS = 4           # consecutive columns j1 one column CTA takes,
SPLIT_CTAS = 512         # ... where the rows give this many CTAs or more
SPLIT_BOX = 256          # the largest box dimension of a tensor copy

_TWIDDLES: dict[tuple[int, torch.device], torch.Tensor] = {}


@dataclass(frozen=True)
class FFTPlan:
    """How the kernel splits one row's m = n/2 point complex FFT.

    A cluster of ``k`` CTAs shares the row, m = k * m2. CTA ``j1``
    loads ``x[j1 + k*j2]`` (j2 < m2) from the audio row, runs an
    m2-point Stockham FFT with ``radices`` (one shared-memory pass and
    barrier each), scales bin f2 by ``W_m^(j1*f2)`` and stores it into
    the shared memory of the CTA that owns f2. CTA ``rank`` owns
    f2 = rank*run + u (u < run = m2/k): it forms the bins
    ``f1*m2 + f2`` (f1 < k) as the k-point DFTs
    ``sum_j1 W_k^(j1*f1) * Y_j1[f2]`` and runs the epilogue (gravity,
    history, average) of those k runs of ``run`` bins.

    A split plan (n above MAX_N, :attr:`split`) takes no cluster: k =
    m / 2048 column CTAs a row, SPLIT_COLS columns j1 each, run the
    same 2048-point FFT, scale by ``W_m^(j1*f2)`` and write
    ``Y[row, j1, f2]`` to a float64 scratch tensor; then a stage CTA,
    launched as the column pass's programmatic dependent, owns
    ``split_run`` consecutive f2 of one row: it copies its gravity and
    history shares into shared memory (:attr:`split_copy`,
    :meth:`split_slots`) before it waits for the column pass, reads
    ``Y[row, :, f2]``, takes the k-point DFTs over j1 as Stockham passes
    of :attr:`stage_radices` on all its columns at once, and runs the
    epilogue on bins ``f1*m2 + f2`` against shared memory.
    """
    n: int
    k: int
    m2: int
    radices: tuple[int, ...]

    @property
    def m(self) -> int:
        return self.n // 2

    @property
    def radix_code(self) -> int:
        """The radices as the kernel reads them: log2 of stage s in
        bits 2s, 2s+1."""
        return _radix_code(self.radices)

    @property
    def split(self) -> bool:
        """Two launches through device memory instead of one cluster."""
        return self.n > MAX_N

    @property
    def stage_radices(self) -> tuple[int, ...]:
        """The split's k-point DFT as Stockham passes of radix 8 and 4."""
        return _radices(self.k)

    @property
    def split_run(self) -> int:
        """Consecutive f2 a stage CTA owns: 1024 points of k-point
        columns where k <= 256, runs of 4 floats (16 bytes, a tensor
        copy's least) to k 1024, 4096 points above, one column at k
        4096."""
        return max(1, min(max(1024, 4 * self.k), 4096) // self.k)

    def split_cols(self, B: int) -> int:
        """Columns a column CTA takes at B rows: SPLIT_COLS, so that a
        thread's loads of one j2 share a 32-byte sector of the audio,
        where that still leaves SPLIT_CTAS CTAs; else 1, for latency at
        a few rows."""
        return SPLIT_COLS if B * self.k >= SPLIT_CTAS * SPLIT_COLS else 1

    @property
    def split_points(self) -> int:
        """Points of a stage CTA: ``k * split_run`` (1024 to k 256, 2048
        at k 512, 4096 above)."""
        return self.k * self.split_run

    @property
    def split_copy(self) -> str:
        """How a stage CTA's gravity and history shares come into shared
        memory: ``"tensor"`` copies where a run is 16 bytes or more (run
        >= 4 floats, k <= 1024; boxes of (run, min(k, SPLIT_BOX), 1), 1
        to 4 a plane), else ``"cp.async"`` (4 bytes each,
        every thread its share: runs of 2 and 1 float at k 2048 and
        4096)."""
        return "tensor" if self.split_run >= 4 else "cp.async"

    @property
    def split_tw_shared(self) -> bool:
        """The k-point twiddles copied into a stage CTA's shared memory
        (k <= 512, where they take at most 8 KB); at 4096 points a CTA
        (k >= 1024) they are read from device memory, so that two
        history slots fit beside the stage's buffers."""
        return self.split_points <= MAX_CTA_POINTS

    def _split_fixed(self, F: int) -> int:
        """A stage CTA's shared memory but its history slots: two
        mbarriers padded to 128 bytes, the stage's two buffers
        (``split_points`` complex doubles each), the k-point twiddles
        where shared, the gravity share (2 planes of ``split_points``
        floats) and the F age weights."""
        P = self.split_points
        return (128 + 32 * P + (16 * self.k if self.split_tw_shared else 0)
                + 8 * P + 4 * F)

    def split_slots(self, F: int) -> int:
        """History slots a stage CTA holds at once (8 * split_points bytes
        each): F, copied in while pass A runs, where they fit (to F 22
        or 23 at k <= 256, 8 at k 512); else fewer, and the ring streams
        through them in groups (2 at k >= 1024)."""
        free = SMEM_LIMIT - self._split_fixed(F)
        return min(F, free // (8 * self.split_points))

    def split_smem(self, F: int, cols: int) -> tuple[int, int]:
        """Dynamic shared memory of a split plan's two CTAs, as
        csrc/fused_update.cu carves it. Column CTA: two mbarriers padded
        to 128 bytes, two FFT buffers, the m2-point twiddles and, with
        more than one column, the W_m^(j1*f2) row of the column at work
        (complex doubles), then ``cols`` staged columns of windowed float
        pairs (112 KB at one column, two CTAs an SM; 192 KB at 4). Stage
        CTA: ``_split_fixed`` and ``split_slots(F)`` history shares."""
        post = 16 * self.m2 if cols > 1 else 0
        return (128 + 48 * self.m2 + post + 8 * cols * self.m2,
                self._split_fixed(F) + 8 * self.split_points * self.split_slots(F))

    def smem_bytes(self, F: int) -> int:
        """Dynamic shared memory of one CTA for a ring of F slots: two
        mbarriers (padded to 128 bytes, the tensor copies' alignment);
        the FFT's two buffers, the receive buffer and the two twiddle
        tables (m2 complex doubles each); the gravity share (2 m2
        floats); ``slots(F)`` history shares (2 m2 floats each); the F
        age weights. csrc/fused_update.cu carves its shared memory in
        this order and takes this size as given."""
        return 128 + 88 * self.m2 + 8 * self.m2 * self.slots(F) + 4 * F

    def slots(self, F: int) -> int:
        """History slots resident at once: F (the whole ring, copied in
        while the FFT runs), or fewer, and then the kernel streams the
        ring through them in groups of that many (the streamed route)."""
        free = SMEM_LIMIT - 128 - 88 * self.m2 - 4 * F
        return min(F, free // (8 * self.m2))


def _radices(points: int) -> tuple[int, ...]:
    """A power of two >= 16 as radix-8 passes with one or two radix-4
    passes where its log2 is not a multiple of 3."""
    p = points.bit_length() - 1
    return {0: (8,) * (p // 3), 1: (8,) * ((p - 4) // 3) + (4, 4),
            2: (8,) * ((p - 2) // 3) + (4,)}[p % 3]


def _radix_code(radices) -> int:
    return sum((int(r).bit_length() - 1) << (2 * s)
               for s, r in enumerate(radices))


@functools.lru_cache(maxsize=None)
def fft_plan(n: int) -> FFTPlan:
    """The kernel's plan for bufsize ``n``: a cluster of k = m/256 CTAs
    (1 to 8, the portable cluster sizes) a row, so each CTA runs a 128-
    to 2048-point FFT; at n 65536, where 8 CTAs would each need 4096
    points, 16 CTAs of 2048. The FFT runs in radix-8 passes with one or
    two radix-4 passes where log2(m2) is not a multiple of 3; each CTA
    owns runs of m2/k >= 32 bins. Above MAX_N (65536) a split plan of
    k = m/2048 column CTAs a row and no cluster, up to MAX_SPLIT_N."""
    if n < MIN_N or n > MAX_SPLIT_N or n & (n - 1):
        raise ValueError(f"fused_update: n must be a power of two in "
                         f"[{MIN_N}, {MAX_SPLIT_N}], got {n}")
    m = n // 2
    k = min(PORTABLE_CLUSTER, max(1, m // 256))
    if m // k > MAX_CTA_POINTS:     # 65536, and every split plan
        k = m // MAX_CTA_POINTS
    m2 = m // k
    return FFTPlan(n, k, m2, _radices(m2))


def twiddle_table(plan: FFTPlan) -> np.ndarray:
    """complex128 (m2 + m,): ``W_m2^t`` for t < m2 (the CTAs' FFT
    passes), then ``W_m^(j1*f2)`` at m2 + j1*m2 + f2 (CTA j1's scaling
    of its bins); a split plan appends ``W_k^t`` for t < k (its k-point
    stage)."""
    m, m2 = plan.m, plan.m2
    inner = np.exp(-2j * np.pi * np.arange(m2) / m2)
    j1, f2 = np.meshgrid(np.arange(plan.k), np.arange(m2), indexing="ij")
    outer = np.exp(-2j * np.pi * (j1 * f2 % m) / m).reshape(-1)
    parts = [inner, outer]
    if plan.split:
        parts.append(np.exp(-2j * np.pi * np.arange(plan.k) / plan.k))
    return np.concatenate(parts)


def age_weights(avg_weights) -> np.ndarray:
    """POSITIONAL oldest-first ``windows.avg_weights`` -> AGE order
    (age 0 = newest). The reference binds its averaging FBOs
    newest-first (render.c:2252-2256), so a ring slot's weight follows
    the age of the frame it holds: ``w_age[(slot - f) mod F]``."""
    # a copy: ascontiguousarray keeps the negative stride of a 1-slot view
    return np.asarray(avg_weights, np.float32)[::-1].copy()


def fused_update_plain(pcm, grav, hist, slot, fft_scale, fft_cutoff, g,
                       window, age_weights, clamp: bool = True):
    """Plain torch version of the fused update; returns new
    ``(grav', hist', avg)`` tensors and leaves its inputs untouched.
    ``clamp`` is the accel path's GL_R16 per-stage clamping
    (render.c:512-523) of the spectrum and the gravity store; without it
    (the CPU path, ``setaccelfft false``) gravity runs unclamped
    (render.c:730-735) and only the average clamps, as the texture."""
    B, n = pcm.shape
    m = n // 2
    F = hist.shape[1]
    spec = fft.packed_spectrum(pcm * window, fft_scale, fft_cutoff)
    if clamp:
        spec = torch.clamp(spec, 0.0, 1.0)
    spec = spec.reshape(B, m, 2).transpose(1, 2)
    grav = torch.maximum(grav, spec) - g[:, None, None]
    if clamp:
        grav = torch.clamp(grav, 0.0, 1.0)
    slot = torch.remainder(slot.long(), F)
    hist = hist.clone()
    hist[torch.arange(B, device=pcm.device), slot] = grav
    return grav, hist, ring_average(hist, slot, age_weights)


def ring_average(hist, newest, age_weights):
    """``clip(sum_f w_age[(newest - f) mod F] * hist[:, f], 0, 1)``,
    summed in f order: the texture source of a ring whose newest frame
    sits in slot ``newest`` (B,)."""
    F = hist.shape[1]
    ages = torch.remainder(
        newest.long()[:, None] - torch.arange(F, device=hist.device), F)
    w = age_weights[ages]                                   # (B, F)
    acc = torch.zeros_like(hist[:, 0])
    for f in range(F):
        acc = acc + w[:, f, None, None] * hist[:, f]
    return torch.clamp(acc, 0.0, 1.0)


def check_length(n: int) -> None:
    """Raise ``ValueError`` unless n is a power of two >= 4, the packed
    FFT's lengths (glava_tpu/ops/fft.py ``plan_packed_fft``)."""
    if n < 4 or n & (n - 1):
        raise ValueError(f"packed fft length must be a power of two >= 4, "
                         f"got {n}")


def update_route(n: int) -> str:
    """How an update at bufsize ``n`` runs: ``"kernel"`` from MIN_N to
    MAX_SPLIT_N (2^24; the one-cluster kernel to MAX_N, the split route
    above it); ``"chain"`` (:func:`chain_update`) below MIN_N, sizes
    under any TPU kernel's too (the JAX package's ``_fused_supported``
    wants n >= 512 and takes its XLA chain below), and above
    MAX_SPLIT_N, where no split plan fits a CTA and the JAX package,
    which sets no upper limit, runs its XLA chain
    (glava_tpu/ops/fft.py ``plan_packed_fft``). Raises ``ValueError``
    unless n is a power of two >= 4, the packed FFT's lengths."""
    check_length(n)
    return "kernel" if MIN_N <= n <= MAX_SPLIT_N else "chain"


def chain_update(pcm, grav, hist, slot, fft_scale, fft_cutoff, g, window,
                 age_weights, clamp: bool = True, avg=None):
    """:func:`fused_update_plain` on the tensors' own device, IN PLACE on
    ``grav`` and ``hist`` like the kernel (and on ``avg`` when given);
    returns ``(grav, hist, avg)``.
    No kernel: the bufsizes below MIN_N on any device, every bufsize on
    the CPU, and the CPU path (``clamp`` off: ``setaccelfft false``,
    where the JAX package takes its XLA chain, never the Pallas kernel,
    glava_tpu/pipeline.py:128-129) at every bufsize."""
    g2, h2, a2 = fused_update_plain(pcm, grav, hist, slot, fft_scale,
                                    fft_cutoff, g, window, age_weights,
                                    clamp)
    grav.copy_(g2)
    hist.copy_(h2)
    if avg is None:
        return grav, hist, a2
    avg.copy_(a2)
    return grav, hist, avg


def fused_update(pcm, grav, hist, slot, fft_scale, fft_cutoff, g,
                 window, age_weights, avg=None):
    """The fused update, IN PLACE on ``grav`` and ``hist``; returns
    ``(grav, hist, avg)``, the average written into ``avg`` when given
    (a step captured into a CUDA graph keeps its outputs at fixed
    addresses), else newly allocated.

    CPU tensors take :func:`chain_update`. CUDA tensors launch the
    kernel, or raise when the inputs are not what it takes."""
    if pcm.device.type == "cpu":
        return chain_update(pcm, grav, hist, slot, fft_scale, fft_cutoff, g,
                            window, age_weights, avg=avg)
    if pcm.device.type != "cuda":
        raise ValueError(f"fused_update: unsupported device {pcm.device}")
    return _launch(pcm, grav, hist, slot, fft_scale, fft_cutoff, g,
                   window, age_weights, avg)


def _twiddles(plan: FFTPlan, device: torch.device) -> torch.Tensor:
    """:func:`twiddle_table` as a (m2 + m, 2) float64 tensor on ``device``."""
    key = (plan.n, device)
    if key not in _TWIDDLES:
        tw = twiddle_table(plan)
        _TWIDDLES[key] = torch.as_tensor(
            np.stack([tw.real, tw.imag], axis=-1), device=device)
    return _TWIDDLES[key]


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"fused_update: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"fused_update: {name} is on {t.device}, pcm on {device}")
    if t.dtype != dtype:
        raise TypeError(f"fused_update: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_update: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"fused_update: {name} must be contiguous")


def _check_aligned(name, t, nbytes):
    # the kernel's tensor copies (grav, hist) take 16-byte-aligned rows;
    # it reads pcm and window as float2 pairs
    if t.data_ptr() % nbytes:
        raise ValueError(f"fused_update: {name} must start on a "
                         f"{nbytes}-byte boundary")


@functools.lru_cache(maxsize=None)
def _plan_args(n: int, F: int) -> tuple[int, ...]:
    """The plan as the C entry takes it: k, the pass count, the radix
    code, the resident history slots and the shared memory in bytes."""
    plan = fft_plan(n)
    return (plan.k, len(plan.radices), plan.radix_code, plan.slots(F),
            plan.smem_bytes(F))


@functools.lru_cache(maxsize=None)
def _split_args(n: int, F: int, B: int) -> tuple[int, ...]:
    """A split plan as its C entry takes it: k, the column FFT's pass
    count and radix code, the k-point stage's, the columns a column CTA
    takes, the f2 a stage CTA owns, the history slots it holds at once,
    whether its history comes by tensor copy, and the two CTAs' shared
    memory."""
    plan = fft_plan(n)
    cols = plan.split_cols(B)
    return (plan.k, len(plan.radices), plan.radix_code,
            len(plan.stage_radices), _radix_code(plan.stage_radices),
            cols, plan.split_run, plan.split_slots(F),
            int(plan.split_copy == "tensor"), *plan.split_smem(F, cols))


_FN: dict[str, object] = {}


def _kernel(entry: str = "glava_fused_update"):
    """A C entry point of the built kernel, resolved once: the
    one-cluster kernel, or ``glava_fused_update_split``."""
    if entry not in _FN:
        from glava_tpu_torch.ops import _build

        fn = getattr(_build.load("fused_update").lib, entry)
        if entry == "glava_fused_update":
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 14
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN[entry] = fn
    return _FN[entry]


def _launch(pcm, grav, hist, slot, fft_scale, fft_cutoff, g, window,
            age_weights, avg=None):
    global launches, split_launches
    if pcm.ndim != 2 or hist.ndim != 4:
        raise ValueError("fused_update: pcm must be (B, n), hist (B, F, 2, m)")
    B, n = pcm.shape
    F = hist.shape[1]
    plan = fft_plan(n)
    if B < 1 or F < 1:
        raise ValueError("fused_update: needs at least one row and one frame")
    m = n // 2
    dev = pcm.device
    f32 = torch.float32
    _check("pcm", pcm, (B, n), f32, dev)
    _check("grav", grav, (B, 2, m), f32, dev)
    _check("hist", hist, (B, F, 2, m), f32, dev)
    _check("slot", slot, (B,), torch.int32, dev)
    for name, t in (("fft_scale", fft_scale), ("fft_cutoff", fft_cutoff),
                    ("g", g)):
        _check(name, t, (B,), f32, dev)
    _check("window", window, (n,), f32, dev)
    _check("age_weights", age_weights, (F,), f32, dev)
    for name, t, nbytes in (("grav", grav, 16), ("hist", hist, 16),
                            ("pcm", pcm, 8), ("window", window, 8)):
        _check_aligned(name, t, nbytes)

    tw = _twiddles(plan, dev)
    if avg is None:
        avg = torch.empty((B, 2, m), dtype=f32, device=dev)
    _check("avg", avg, (B, 2, m), f32, dev)
    ptrs = (pcm.data_ptr(), window.data_ptr(), tw.data_ptr(),
            age_weights.data_ptr(), slot.data_ptr(), fft_scale.data_ptr(),
            fft_cutoff.data_ptr(), g.data_ptr(), grav.data_ptr(),
            hist.data_ptr(), avg.data_ptr())
    if plan.split:
        fn = _kernel("glava_fused_update_split")
        # Y[row, j1, f2], the column FFTs' scaled bins, as complex doubles
        scratch = torch.empty((B, m, 2), dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*ptrs, scratch.data_ptr(), B, n, F, *_split_args(n, F, B),
                     stream)
    else:
        fn = _kernel()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*ptrs, B, n, F, *_plan_args(n, F), stream)
    if err != 0:
        raise RuntimeError(f"fused_update kernel launch failed: CUDA error {err}")
    if plan.split:
        split_launches += 1
    else:
        launches += 1
    return grav, hist, avg

"""Timing on the card: the port's one set of timers.

The counterpart of ``glava_tpu/utils/timing.py``. The JAX module times a
scan of calls by the slope between two run lengths, each ended by
fetching a probe, because the TPU runtime's ``block_until_ready`` could
return early. CUDA needs none of that: ``torch.cuda.synchronize()``
returns when the card is done, and CUDA events and torch.profiler read
the device's own clock. ``chip_smoke.py`` and ``glava_tpu_torch.bench``
both time through this module.

* :func:`host_ms`: the host clock around back-to-back calls that end in
  a synchronise, what a caller's eager loop sees, launches included
  (``time.perf_counter`` alone on the CPU).
* :func:`cuda_ms`: CUDA events around back-to-back calls.
* :func:`event_ms`: CUDA events around calls queued behind a spin
  kernel, the device alone.
* :func:`device_ms` and :func:`kernel_ms`: torch.profiler's device time,
  of every kernel a call launches or of the named ones.
* :func:`bound_ms`, :func:`fused_bound`: the least time the card could
  take, from the data sheet's rates (NVIDIA H100 SXM, 700 W).

Every CUDA timer raises without a card: nothing falls back to the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from glava_tpu_torch.device import resolve

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
FP64_FLOPS = 34e12          # H100 SXM float64 outside the tensor cores (data sheet)


def _need_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times the card, but "
                           "torch.cuda.is_available() is False")


def synchronize(devices=None) -> None:
    """Wait for the card of each of ``devices`` (CUDA devices, names or
    indices; CPU devices are passed over), or for every visible card
    when ``devices`` is None."""
    if devices is None:
        devices = range(torch.cuda.device_count())
    for d in devices:
        d = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def host_ms(fn, iters: int, device="cuda", warmup: int = 1) -> float:
    """Mean host milliseconds per call of ``fn(i)``, i = 0 .. iters-1,
    run back to back after ``warmup`` warm-up calls ``fn(0)``: the host
    clock from a synchronised start to the synchronise after the last
    call. ``device`` is the device the calls run on, or a list of them
    for a loop over several cards; only those are synchronised. On the
    CPU the calls are synchronous and ``time.perf_counter`` alone times
    them."""
    many = isinstance(device, (list, tuple))
    devs = [resolve(d) for d in (device if many else (device,))]
    for _ in range(warmup):
        fn(0)
    synchronize(devs)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    synchronize(devs)
    return (time.perf_counter() - t0) / iters * 1e3


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events,
    after a warm-up)."""
    _need_card("cuda_ms")
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def event_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn(i)``, i = 0 .. iters-1,
    from CUDA events: the calls are enqueued behind a spin kernel
    (``torch.cuda._sleep``) that outlasts their enqueueing, so the card
    runs them back to back and the events time the device alone, not
    the host's launches. ``fn`` must not synchronise; the check that the
    spin was still running when the last call was enqueued makes sure."""
    _need_card("event_ms")
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * enqueue * 2e9) + 10_000_000     # ~4x at up to 2 GHz
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError("event_ms: the spin kernel never outlasted the "
                         "enqueueing of the timed calls")


def _profiled(fn, iters: int):
    """key_averages of ``iters`` calls of ``fn`` under torch.profiler
    (CUDA activity), ended by a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_ms(fn, iters: int = 100, tries: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``: the kernels' own
    time from torch.profiler (the sum of every device event's self
    time), free of the host's launch overhead that an event-timed loop
    of small launches measures instead. A profile that recorded no
    device time (CUPTI drops one now and then) is taken again; after
    ``tries`` such profiles it raises: a time from another clock would
    not mean the same."""
    _need_card("device_ms")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        busy = sum(e.self_device_time_total for e in _profiled(fn, iters))
        if busy > 0:
            return busy / 1e3 / iters
    raise AssertionError(f"device_ms: torch.profiler recorded no device time "
                         f"in {tries} profiles")


def kernel_ms(fn, names, iters: int = 100, tries: int = 3) -> dict:
    """Device milliseconds a call of ``fn`` spent in each kernel whose
    name holds one of ``names``: torch.profiler's ``key_averages`` by
    kernel name, on warm inputs. Fails if a profile never records one of
    them (no fallback: a time per kernel has no other source)."""
    _need_card("kernel_ms")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        events = _profiled(fn, iters)
        out = {name: sum(e.self_device_time_total for e in events
                         if name in e.key) / 1e3 / iters for name in names}
        if all(v > 0 for v in out.values()):
            return out
    raise AssertionError(f"kernel_ms: no device time recorded for {names} in "
                         f"{tries} profiles")


def update_bytes(n: int, B: int, F: int) -> int:
    """Bytes the fused update must move at bufsize ``n`` over ``B`` rows
    with ``F`` averaging frames. Read once: pcm, window, weights, slots
    and 3 row parameters, gravity and the F - 1 history slots a row does
    not overwrite (nothing reads the old value of its own slot). Written
    once: gravity, that slot and the average."""
    plane = B * n * 4            # one (B, 2, m) float32 plane set
    return (B * n * 4 + n * 4 + F * 4 + 4 * B * 4 + plane + (F - 1) * plane
            + 3 * plane)


def bound_ms(nbytes: float) -> float:
    """Least time to move ``nbytes`` through device memory. Every kernel
    here does a handful of operations a byte (compares, selects, one
    float64 FFT of ~5 m log2 m flops a row), orders of magnitude under
    the card's peak rates, so the bytes bound each one."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def fused_bound(n: int, B: int, nbytes: int) -> tuple[float, str, float]:
    """The fused update's bound in ms, what sets it, and the operations'
    time: the larger of its bytes over the memory rate and its float64
    FFT (5 m log2 m flops a row, m = n/2) over the card's float64 rate."""
    m = n // 2
    ops = B * 5 * m * np.log2(m) / FP64_FLOPS * 1e3
    by_bytes = bound_ms(nbytes)
    return (max(by_bytes, ops), "bytes" if by_bytes >= ops else "operations",
            ops)

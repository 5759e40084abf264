"""The while node: a data-dependent loop inside one captured step.

The JAX interpreter lowers a GLSL loop whose trip count depends on the
data to ``lax.while_loop`` (glava_tpu/config/glsl_shader.py:2095-2147),
so a jitted shader step runs it on the device with no host read. The
port's counterpart is a CUDA conditional WHILE graph node
(``csrc/graph_while.cu``): :func:`run` takes the loop state as
tensors the body rewrites in place (an ``active`` bool plane and an
int32 ``fuel`` count) and

* inside a CUDA graph capture, adds the node to the graph the current
  stream captures into and captures ``body`` once into the node's body
  graph, on a stream of its own, its allocations in the capture's
  memory pool (``compiled.pool_by_thread``). The setter kernel runs before the node and at the end of
  every iteration: the loop goes on while a pixel is active and the
  fuel is below the cap. Nested loops are nested nodes;
* outside a capture, on the card (the eager step, and a compiled
  step's warm-up call), runs ``body`` from the host, the setter
  kernel's answer read back each iteration;
* on CPU tensors (the plain version) runs ``body`` from the host, the
  condition read where the tensors live: on the CPU that is the device.

Every buffer the body reads from one iteration to the next must exist
before the loop and be written in place (an iteration replays at fixed
addresses). ``launches`` counts the setter's launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

launches = 0

_TO_BOOL = torch.Tensor.__bool__
_FNS: dict = {}
_STREAMS: dict = {}            # device index -> free body-capture streams
_LOCAL = threading.local()     # .depth: bodies being captured, this thread
# cudaStreamCaptureModeThreadLocal: the mode every compiled step captures in
_MODE = 1


def _lib():
    if not _FNS:
        from glava_tpu_torch.ops import _build

        lib = _build.load("graph_while").lib
        lib.glava_while_set.argtypes = [
            ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.glava_while_handle.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.glava_while_open.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int]
        lib.glava_while_close.argtypes = [ctypes.c_void_p]
        lib.glava_while_stream.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        for name in ("glava_while_set", "glava_while_handle",
                     "glava_while_open", "glava_while_close",
                     "glava_while_stream"):
            getattr(lib, name).restype = ctypes.c_int
        _FNS["lib"] = lib
    return _FNS["lib"]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"graph_while: {what} failed: CUDA error {err}")


def capturing_body() -> bool:
    """Whether this thread is capturing a loop body (values made now
    live in that body's graph: nothing after the loop may reuse them)."""
    return getattr(_LOCAL, "depth", 0) > 0


def condition_plain(active: torch.Tensor, fuel: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """The setter's value as a tensor: ``any(active) and fuel < cap``."""
    return active.any() & (fuel.reshape(()) < cap)


def set_condition(active: torch.Tensor, fuel: torch.Tensor, cap: int,
                  sync: torch.Tensor, go: torch.Tensor,
                  handle: int | None = None) -> None:
    """Launch the setter on the current stream: ``go`` (int32, one
    element) = :func:`condition_plain`, and the conditional ``handle``
    set to it when given. ``sync``: two zeroed int32 words the launches
    of one loop share. ``active`` may hold any number of bytes (16 at a
    time, the rest one by one)."""
    global launches
    if not (active.is_cuda and active.dtype == torch.bool
            and active.is_contiguous() and active.data_ptr() % 16 == 0):
        raise ValueError("graph_while: active must be a contiguous, 16-byte "
                         "aligned bool tensor on the card")
    for name, t in (("fuel", fuel), ("sync", sync), ("go", go)):
        if t.device != active.device or t.dtype != torch.int32:
            raise ValueError(f"graph_while: {name} must be int32 on "
                             f"{active.device}")
    with torch.cuda.device(active.device):
        stream = torch.cuda.current_stream(active.device).cuda_stream
        _check(_lib().glava_while_set(
            0 if handle is None else handle, int(handle is not None),
            active.data_ptr(), active.numel(), fuel.data_ptr(), int(cap),
            sync.data_ptr(), go.data_ptr(), stream), "the setter's launch")
    launches += 1


def run(active: torch.Tensor, fuel: torch.Tensor, cap: int, body,
        warm: bool = False) -> None:
    """``while any(active) and fuel < cap: body()`` (module docstring).
    ``body`` rewrites ``active`` and advances ``fuel`` in place. With
    ``warm`` (a compiled step's warm-up call) a loop that ran no
    iteration runs ``body`` once more all the same, ``fuel`` put back
    after it: with no pixel active an iteration changes no value, and
    the capture then meets only what the warm-up built."""
    if active.device.type == "cpu":
        n = 0
        while _TO_BOOL(condition_plain(active, fuel, cap)):
            body()
            n += 1
    elif not torch.cuda.is_current_stream_capturing():
        sync = torch.zeros(2, dtype=torch.int32, device=active.device)
        go = torch.zeros(1, dtype=torch.int32, device=active.device)
        n = 0
        while True:
            set_condition(active, fuel, cap, sync, go)
            if not go.item():
                break
            body()
            n += 1
    else:
        _node(active, fuel, cap, body)
        return
    if warm and n == 0:
        saved = fuel.clone()
        body()
        fuel.copy_(saved)


def _node(active, fuel, cap, body) -> None:
    from glava_tpu_torch import compiled

    dev = active.device
    lib = _lib()
    sync = torch.zeros(2, dtype=torch.int32, device=dev)
    go = torch.zeros(1, dtype=torch.int32, device=dev)
    parent = torch.cuda.current_stream(dev)
    handle = ctypes.c_ulonglong()
    _check(lib.glava_while_handle(parent.cuda_stream, ctypes.byref(handle)),
           "creating a conditional handle")
    set_condition(active, fuel, cap, sync, go, handle.value)
    child = _take_stream(dev)
    _check(lib.glava_while_open(parent.cuda_stream, child, handle.value,
                                _MODE), "opening the while node")
    compiled.pool_by_thread(dev)
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        with torch.cuda.stream(torch.cuda.ExternalStream(child, device=dev)):
            body()
            set_condition(active, fuel, cap, sync, go, handle.value)
    finally:
        _LOCAL.depth -= 1
        err = lib.glava_while_close(child)
        _STREAMS[dev.index].append(child)
    _check(err, "closing the while node's body")


def _take_stream(dev: torch.device) -> int:
    free = _STREAMS.setdefault(dev.index, [])
    if free:
        return free.pop()
    s = ctypes.c_void_p()
    with torch.cuda.device(dev):
        _check(_lib().glava_while_stream(ctypes.byref(s)),
               "creating a body stream")
    return s.value

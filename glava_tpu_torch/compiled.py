"""Compiled steps: the port's counterpart of the JAX package's jitted,
donated steps (``jax.jit(step, donate_argnums=(0,))``).

The JAX package never runs a frame op by op: ``Renderer.jit_step``,
``AudioPipeline.jit_update``, the fleet's step and ``render_wav`` each
run one compiled executable a call, the caller's state donated to it.
The port captures such a step into a ``torch.cuda.CUDAGraph`` on the
card and replays it once a call. :class:`Step` holds what every
compiled step shares:

* **static inputs**: each per-call input has a buffer on the device, a
  view of one flat buffer. A call's host values are packed into a
  pinned staging buffer (one of a ring the step owns, reused once the
  copy from it is done) and reach the device in ONE host-to-device copy
  of the span they cover, made before the replay and outside the
  graph; a value already on the device is copied device to device.
  Live pipe values are static inputs too, one slot a pipe name
  (``pipe:<name>``), so one graph serves every value, as JAX traces
  them as arguments; a new set of names or shapes is a new input
  layout, and the next call captures anew (JAX retraces on a new
  pytree structure);
* **the donated state** (:meth:`Step.donate`): the step keeps the state
  in static buffers, the body updates them in place, and the call
  returns them. A state that is not the step's own is copied in;
* **branches**: a choice the host makes (whether new audio arrived, a
  wallpaper was given) picks one graph of several. Each graph has its
  own memory pool, and every tensor that passes between graphs (the
  state, the inputs) is static, so replays in any order are safe;
* **warm-up, then capture**: the first call of a branch runs the body
  eagerly on a side stream (that call's own result: it builds the
  kernels, makes their shared-memory opt-ins, fills the twiddle, cuFFT
  plan and constant caches), then captures the body; every later call
  replays the graph. :attr:`Step.captures` counts the captures;
* **host constants** (:func:`const`): a value a body makes from host
  data (a GLSL shader's coordinate planes, a plan's index rows) is
  uploaded once, in the warm-up, into a cache the step owns, and every
  later run of the body (the capture, and every CPU call) takes the
  cached tensor; one first met in a capture raises. :func:`hold`
  keeps alive what a graph reads from a cache outside the step;
* **on the CPU** (the tests) the same body runs eagerly on the same
  static buffers, its outputs copied into one static output a branch,
  as a replay leaves them. There is no graph on the CPU.

The step keeps no reference to its owner (the body is passed to each
:meth:`Step.run`), and Python's cyclic garbage collector is held off
while a capture runs: a dead graph collected in the middle of another
graph's capture would be torn down inside it, which invalidates the
capture.

The outputs of a call are the step's static buffers: the next call of
the same branch overwrites them (``runtime.engine.FrameFetch`` copies a
frame out before that). A replay adds to each kernel's launch count
(``ops.fused.launches`` and the others, :data:`COUNTERS`) the launches
its graph holds; the capture itself launches nothing and counts
nothing. A replay's ``step.replay`` span carries the kernel nodes of
its graph, counted once from the graph after its capture has ended
(:func:`graph_kernels`). A failed capture or replay raises: nothing
runs the eager step in its place. A data-dependent GLSL loop is a
conditional while node of the graph (``ops.graph_while``).

A user Python module's passes run under a guard in every run of a
body (:func:`user_pass`): a host read of a tensor's value, or a tensor
made from host data, raises :class:`Uncapturable` naming the module,
on the CPU as on the card (the counterpart of a JAX trace error on a
module that reads concrete values), and so does whatever else fails in
its pass during the capture (a CUDA capture error), with its cause. A
capture that raises is ended with the allocator's routing to its pool,
so the next step captures normally (:func:`_capturing`).
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
from typing import Callable

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from glava_tpu_torch.utils import profiling

# the counters a replay advances (module of glava_tpu_torch.ops or the
# renderer, attribute), an int or a dict of ints: kernel launches, the
# row-wise lookup's routes and the renderer's whole-frame band renders
COUNTERS = (("fused", "launches"), ("fused", "split_launches"),
            ("lookup", "launches"), ("lookup", "rowwise_launches"),
            ("lookup", "rowwise_routes"), ("latch", "launches"),
            ("raster", "launches"), ("smooth", "launches"),
            ("graph_while", "launches"), ("renderer", "whole_frame_bands"))

_ALIGN = 16     # bytes between static inputs in the flat buffer
_STAGING = 64 << 20   # pinned bytes a step's staging ring may hold
_MODULES: dict = {}
# captures underway, and whether the garbage collector ran before them
_GC = {"captures": 0, "was_enabled": True, "lock": threading.Lock()}
# the step whose body this thread runs (.step), the run's phase (.phase:
# "warm", "capture" or "cpu"), the capture's memory pool (.pool), whether
# the pool takes every allocation of the thread (.by_thread), the user
# module whose pass this thread runs (.user) and whether the port itself
# makes a tensor inside it (.trusted, :func:`const`)
_LOCAL = threading.local()


class Uncapturable(ValueError):
    """A compiled step's body met what a capture cannot take (a host
    value the warm-up did not make, a user module's host read): the
    module is refused by name. ``module``: the module the refusal names,
    when the raise knows it."""

    def __init__(self, msg: str, module: str | None = None):
        super().__init__(msg if module is None else
                         f"module '{module}' has no compiled step: {msg}")
        self.module = module


# -- the guard of a user module's passes ---------------------------------

# Tensor methods that bring a tensor's value to the host (printing one
# formats its values there)
HOST_READS = frozenset(("item", "tolist", "numpy", "cpu", "__bool__",
                        "__float__", "__int__", "__index__", "__complex__",
                        "__array__", "__repr__", "__format__"))
# Tensor methods that may move a value to the host (``_host_move``)
MOVES = frozenset(("to", "copy_"))
# functions that make a tensor of their first argument's data
HOST_DATA = frozenset(("tensor", "as_tensor", "asarray", "from_numpy"))
# torch.from_numpy as it was before the first of the user passes that
# run now (on any thread) replaced it
_FROM_NUMPY = {"users": 0, "lock": threading.Lock(), "fn": None}


def _host_move(name: str, args: tuple, kwargs: dict) -> bool:
    """Whether a ``Tensor.to`` or ``Tensor.copy_`` call brings a value
    to the host: a destination on the CPU from a source that is not, or
    a ``to`` whose device is spelled ``"cpu"`` (the host, on the CPU as
    on the card)."""
    if name == "copy_":
        src = args[1] if len(args) > 1 else kwargs.get("src")
        return (isinstance(src, torch.Tensor) and args[0].device.type == "cpu"
                and src.device.type != "cpu")
    if any(isinstance(a, str) and torch.device(a).type == "cpu"
           for a in (*args[1:], kwargs.get("device"))):
        return True
    device = torch._C._nn._parse_to(*args[1:], **kwargs)[0]
    return (device is not None and device.type == "cpu"
            and args[0].device.type != "cpu")


class _UserPassMode(TorchFunctionMode):
    """Refuses, inside one user module's pass, the calls that would read
    a value on the host or freeze host data into a graph."""

    def __init__(self, module: str):
        super().__init__()
        self.module = module

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_LOCAL, "trusted", False):
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        first = args[0] if args else None
        if isinstance(first, torch.Tensor) and (
                name in HOST_READS
                or name in MOVES and _host_move(name, args, kwargs)):
            raise Uncapturable(f"its pass reads a tensor on the host "
                               f"(Tensor.{name})", self.module)
        if name in HOST_DATA and not isinstance(first, torch.Tensor):
            raise Uncapturable(f"its pass makes a tensor from host data "
                               f"(torch.{name})", self.module)
        return func(*args, **kwargs)


def _from_numpy(a):
    """``torch.from_numpy`` while a user pass runs on some thread (the
    function takes no tensor, so no torch function mode sees it)."""
    module = getattr(_LOCAL, "user", None)
    if module is not None and not getattr(_LOCAL, "trusted", False):
        raise Uncapturable("its pass makes a tensor from host data "
                           "(torch.from_numpy)", module)
    return _FROM_NUMPY["fn"](a)


@contextlib.contextmanager
def user_pass(module: str):
    """Run one pass of the user Python module ``module`` (a
    ``ModuleBuild.render`` call). Inside a compiled step's body (its
    warm-up, its capture and every CPU run) the pass is guarded: a host
    read (``HOST_READS``, a move to the host: ``_host_move``) or a
    tensor made from host data
    (``HOST_DATA``) raises :class:`Uncapturable` naming the module, and
    any error of the pass during the capture is re-raised as
    one, with its cause. Outside a body (the eager step) it runs as
    written."""
    if not in_step():
        yield
        return
    with _FROM_NUMPY["lock"]:
        if _FROM_NUMPY["users"] == 0:
            _FROM_NUMPY["fn"] = torch.from_numpy
            torch.from_numpy = _from_numpy
        _FROM_NUMPY["users"] += 1
    saved = getattr(_LOCAL, "user", None)
    _LOCAL.user = module
    try:
        with _UserPassMode(module):
            yield
    except Uncapturable:
        raise
    except Exception as e:
        if _LOCAL.phase != "capture":
            raise
        raise Uncapturable(f"its pass failed inside the capture: "
                           f"{type(e).__name__}: {e}", module) from e
    finally:
        _LOCAL.user = saved
        with _FROM_NUMPY["lock"]:
            _FROM_NUMPY["users"] -= 1
            if _FROM_NUMPY["users"] == 0:
                torch.from_numpy = _FROM_NUMPY["fn"]


# -- launch counters -----------------------------------------------------


def _counter_modules() -> dict:
    if not _MODULES:
        from glava_tpu_torch import renderer
        from glava_tpu_torch.ops import (
            fused, graph_while, latch, lookup, raster, smooth,
        )

        _MODULES.update(fused=fused, graph_while=graph_while, latch=latch,
                        lookup=lookup, raster=raster, smooth=smooth,
                        renderer=renderer)
    return _MODULES


def read_counters() -> dict:
    mods = _counter_modules()
    out = {}
    for m, a in COUNTERS:
        v = getattr(mods[m], a)
        out[m, a] = dict(v) if isinstance(v, dict) else v
    return out


def _restore_counters(saved: dict) -> None:
    mods = _counter_modules()
    for (m, a), v in saved.items():
        setattr(mods[m], a, dict(v) if isinstance(v, dict) else v)


def _counter_delta(before: dict, after: dict) -> dict:
    out = {}
    for k, v in after.items():
        b = before[k]
        if isinstance(v, dict):
            d = {c: n - b.get(c, 0) for c, n in v.items() if n != b.get(c, 0)}
        else:
            d = v - b
        if d:
            out[k] = d
    return out


def _add_counters(delta: dict) -> None:
    mods = _counter_modules()
    for (m, a), d in delta.items():
        if isinstance(d, dict):
            cur = getattr(mods[m], a)
            for c, n in d.items():
                cur[c] = cur.get(c, 0) + n
        else:
            setattr(mods[m], a, getattr(mods[m], a) + d)


# -- pytrees of tensors ----------------------------------------------------


def leaves(x) -> list[torch.Tensor]:
    """The tensors of a tensor, tuple (named or not), list or dict, in
    order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return []


def tree_map(fn: Callable, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


# the numpy type of each static input type
NP = {torch.float32: np.float32, torch.bool: np.bool_, torch.int32: np.int32}


def in_step() -> bool:
    """Whether this thread runs a compiled step's body."""
    return getattr(_LOCAL, "step", None) is not None


def warming() -> bool:
    """Whether this thread runs a compiled step's warm-up call (the
    eager run before a capture)."""
    return getattr(_LOCAL, "phase", None) == "warm"


def pool_by_thread(device) -> None:
    """Route every allocation this thread makes, on any stream, to the
    memory pool of the capture it runs, for the rest of the capture (a
    while node's body is captured on a stream of its own, which the
    capture's own routing, by its capture id, does not take). The
    allocator keeps one routing a pool: the capture's is ended, and the
    capture's end ends this one."""
    if getattr(_LOCAL, "phase", None) != "capture":
        raise RuntimeError("a while node is captured only inside a "
                           "compiled step's capture")
    if _LOCAL.by_thread:
        return
    idx = torch.device(device).index
    torch._C._cuda_endAllocateToPool(idx, _LOCAL.pool)
    torch._C._cuda_beginAllocateCurrentThreadToPool(idx, _LOCAL.pool)
    # the routing took a reference to the pool; the graph holds its own
    torch._C._cuda_releasePool(idx, _LOCAL.pool)
    _LOCAL.by_thread = True


_FINGERPRINT = 4096   # elements of a constant that key its cache entry


def const(x, device=None) -> torch.Tensor:
    """``torch.as_tensor(x, device=device)`` for host data ``x`` (a
    Python number or a numpy array; float64 and int64 stay as given,
    the caller narrows). Inside a compiled step's body the tensor comes
    from the step's cache, keyed by the value: made in the warm-up call
    (or a CPU step's first), then reused, so a capture makes none (a
    host-to-device copy inside a graph would freeze a pageable read). A
    value first met in a capture raises :class:`Uncapturable`."""
    step = getattr(_LOCAL, "step", None)
    if step is None:
        return torch.as_tensor(x, device=device)
    dev = torch.device(device if device is not None else "cpu")
    # the upload happens once, so a user module's pass may make it
    _LOCAL.trusted = True
    try:
        return _const(step, x, dev)
    finally:
        _LOCAL.trusted = False


def _const(step, x, dev) -> torch.Tensor:
    a = np.asarray(x)
    flat = a.reshape(-1)
    stride = max(1, flat.size // _FINGERPRINT)
    key = (str(dev), type(x).__name__ if not isinstance(x, np.ndarray)
           else "", a.dtype.str, a.shape, flat[::stride].tobytes())
    for host, t in step._consts.get(key, ()):
        if np.array_equal(host, a):
            return t
    if _LOCAL.phase == "capture":
        raise Uncapturable(
            f"a host value of shape {a.shape} ({a.dtype}) first met inside "
            "a capture: the warm-up call did not make it")
    t = torch.as_tensor(x, device=dev)
    step._consts.setdefault(key, []).append((a.copy(), t))
    return t


def hold(obj) -> None:
    """Keep ``obj`` (a tensor or what holds tensors, from a cache outside
    the step) alive as long as the step whose body this thread runs:
    its graphs may read it."""
    step = getattr(_LOCAL, "step", None)
    if step is not None:
        step._held[id(obj)] = obj


# CUgraphNodeType values (libcuda): a kernel, and the two node types
# that hold graphs of their own (a child graph, a conditional node)
_KERNEL_NODE, _CHILD_NODE, _CONDITIONAL_NODE = 0, 4, 13
_LIBCUDA: dict = {}


def _libcuda():
    if "lib" not in _LIBCUDA:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphGetNodes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphNodeGetType.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        _LIBCUDA["lib"] = lib
    return _LIBCUDA["lib"]


def graph_kernels(graph: torch.cuda.CUDAGraph) -> int:
    """The kernel nodes of ``graph``, made with ``keep_graph=True`` and
    its capture ended: the kernels a replay launches. 0 where the graph
    holds a node with a graph of its own (a GLSL loop's while node,
    whose body is not walked) or where libcuda does not say: no
    count rather than a short one."""
    lib, handle = _libcuda(), ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t()
    if lib.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        return 0
    nodes = (ctypes.c_void_p * n.value)()
    if lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        return 0
    kernels, kind = 0, ctypes.c_int()
    for node in nodes[:n.value]:
        if (lib.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0
                or kind.value in (_CHILD_NODE, _CONDITIONAL_NODE)):
            return 0
        kernels += kind.value == _KERNEL_NODE
    return kernels


@contextlib.contextmanager
def _body_of(step, phase: str, pool=None):
    saved = (getattr(_LOCAL, "step", None), getattr(_LOCAL, "phase", None),
             getattr(_LOCAL, "pool", None), getattr(_LOCAL, "by_thread", False))
    _LOCAL.step, _LOCAL.phase, _LOCAL.pool = step, phase, pool
    _LOCAL.by_thread = False
    try:
        yield
    finally:
        (_LOCAL.step, _LOCAL.phase, _LOCAL.pool, _LOCAL.by_thread) = saved


@contextlib.contextmanager
def _capturing(graph, pool, stream):
    """``torch.cuda.graph(graph, pool=pool, stream=stream,
    capture_error_mode="thread_local")`` (thread_local: another thread's
    engine may make calls that a global capture forbids; an api.entry
    engine runs on a thread of its own), except that a body that raises
    leaves nothing capturing: the stream's capture is ended (an
    invalidated capture makes ``capture_end`` raise after it ended it),
    and so is the allocator's routing to the pool, which that raise
    skips; the current stream is restored and the body's error goes
    on."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            yield
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                with contextlib.suppress(RuntimeError):
                    torch._C._cuda_endAllocateToPool(stream.device.index, pool)
            raise
        graph.capture_end()


@contextlib.contextmanager
def _no_gc():
    """Python's cyclic garbage collector held off (for every thread)
    while any capture runs."""
    with _GC["lock"]:
        if _GC["captures"] == 0:
            _GC["was_enabled"] = gc.isenabled()
            gc.disable()
        _GC["captures"] += 1
    try:
        yield
    finally:
        with _GC["lock"]:
            _GC["captures"] -= 1
            if _GC["captures"] == 0 and _GC["was_enabled"]:
                gc.enable()


class Step:
    """One compiled step (module docstring): the owner's ``body(branch)``,
    given to each :meth:`run`, reads :attr:`inputs` and the donated
    :attr:`state` and returns its outputs (a tensor, or a tuple or dict
    of them). ``dtypes`` names the per-call inputs and their types;
    :meth:`load` adds a ``pipe:<name>`` float32 input a pipe name. The
    shapes are the call's: a new layout captures anew. ``name`` (the
    modules the step renders) names them when a capture refuses the
    body (:class:`Uncapturable`)."""

    def __init__(self, device, dtypes: dict, name: str | None = None):
        self.device = torch.device(device)
        self.name = name
        self.base = dict(dtypes)
        self.dtypes = dict(dtypes)
        self.inputs: dict[str, torch.Tensor] = {}
        self.state = None
        self.captures = 0         # graphs captured (CPU: branches first run)
        self._layout: dict = {}   # name -> (offset, nbytes, shape)
        self._key = None          # the layout's (name, shape) key
        self._flat = None
        # [pinned staging buffer, the event after its copy, recorded?]
        self._stages: list = []
        self._calls = 0
        # branch -> (graph, outputs, counts, its kernel nodes)
        self._graphs: dict = {}
        self._outs: dict = {}     # branch -> static outputs (CPU)
        self._consts: dict = {}   # const(): key -> [(host value, tensor)]
        self._held: dict = {}     # hold(): what the graphs read elsewhere
        self._capture_stream = None

    # -- the donated state ------------------------------------------------

    def donate(self, state):
        """The step's static state, with ``state``'s values when it is
        not the step's own (the first call, or a caller's fresh state)."""
        if self.state is None:
            self.state = tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      device=self.device), state)
        mine, given = leaves(self.state), leaves(state)
        if len(mine) != len(given):
            raise ValueError("a compiled step's state keeps its structure")
        for m, g in zip(mine, given):
            if g is not m:
                m.copy_(g)
        return self.state

    # -- static inputs ----------------------------------------------------

    def _allocate(self, shapes: dict) -> None:
        """A new input layout: new static buffers, and every graph (which
        reads the old ones) dropped."""
        self._graphs.clear()
        self._outs.clear()
        self._stages = []
        self._layout = {}
        self.inputs = {}
        off = 0
        for name, dtype in self.dtypes.items():
            shape = tuple(shapes[name])
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self._layout[name] = (off, nbytes, shape)
            off += -(-nbytes // _ALIGN) * _ALIGN
        self._flat = torch.zeros(max(off, _ALIGN), dtype=torch.uint8,
                                 device=self.device)
        for name, (o, n, shape) in self._layout.items():
            self.inputs[name] = (self._flat[o:o + n].view(self.dtypes[name])
                                 .view(shape))

    def load(self, pipe: dict | None = None, **values) -> None:
        """Copy one call's inputs (every name of the step's ``dtypes``,
        and the pipe values, name -> value, each into ``pipe:<name>``)
        into the static buffers: host values (numbers, numpy arrays, CPU
        tensors) through one pinned staging buffer and one host-to-device
        copy, device tensors device to device; all before the replay,
        outside the graph."""
        if set(values) != set(self.base):
            raise ValueError(f"a compiled step takes {sorted(self.base)}, "
                             f"got {sorted(values)}")
        ts = profiling.begin()
        values.update({f"pipe:{k}": v for k, v in sorted((pipe or {})
                                                          .items())})
        shapes = {k: tuple(np.shape(v)) if not isinstance(v, torch.Tensor)
                  else tuple(v.shape) for k, v in values.items()}
        key = tuple((k, shapes[k]) for k in values)
        if key != self._key:
            self.dtypes = {k: self.base.get(k, torch.float32) for k in values}
            self._allocate(shapes)
            self._key = key
        on_dev = {k: v for k, v in values.items()
                  if isinstance(v, torch.Tensor) and v.device.type != "cpu"}
        host = {k: v for k, v in values.items() if k not in on_dev}
        if self.device.type == "cpu":
            for k, v in values.items():
                self.inputs[k].copy_(v if isinstance(v, torch.Tensor) else
                                     torch.from_numpy(np.array(
                                         v, NP[self.dtypes[k]])))
            if ts:
                profiling.end("step.load", ts,
                              sum(self._layout[k][1] for k in values))
            return
        if host:
            stage = self._stage()
            buf = stage[0].numpy()
            for k, v in host.items():
                o, n, shape = self._layout[k]
                dst = buf[o:o + n].view(NP[self.dtypes[k]]).reshape(shape)
                dst[...] = v.numpy() if isinstance(v, torch.Tensor) else v
            lo = min(self._layout[k][0] for k in host)
            hi = max(self._layout[k][0] + self._layout[k][1] for k in host)
            with torch.cuda.device(self.device):
                self._flat[lo:hi].copy_(stage[0][lo:hi], non_blocking=True)
                stage[1].record()
                stage[2] = True
        for k, v in on_dev.items():
            self.inputs[k].copy_(v)
        if ts:
            profiling.end("step.load", ts, hi - lo if host else 0)

    def pipe(self) -> dict:
        """The pipe values' static inputs: name -> tensor."""
        return {k[5:]: t for k, t in self.inputs.items()
                if k.startswith("pipe:")}

    def _stage(self) -> list:
        """The next pinned staging buffer of the ring, once the copy
        made from it before has finished (a wait only when the host runs
        the ring's length of calls ahead of the card)."""
        if not self._stages:
            n = self._flat.numel()
            self._stages = [[torch.empty(n, dtype=torch.uint8,
                                         pin_memory=True),
                             torch.cuda.Event(), False]
                            for _ in range(max(2, min(8, _STAGING // n)))]
        stage = self._stages[self._calls % len(self._stages)]
        self._calls += 1
        if stage[2]:
            ts = profiling.begin()
            if not ts:
                stage[1].synchronize()
            elif not stage[1].query():
                stage[1].synchronize()
                profiling.end("step.stage_wait", ts)
        return stage

    # -- run: warm-up and capture, or replay -------------------------------

    def run(self, branch, body: Callable):
        """``body``'s outputs for ``branch`` on the loaded inputs:
        replayed from its graph on the card, after a first call that
        runs it eagerly and captures it; run eagerly on the CPU. What
        the capture cannot take raises :class:`Uncapturable` naming
        the step's modules."""
        try:
            return self._run(branch, body)
        except Uncapturable as e:
            if self.name is None or e.module is not None:
                raise
            raise Uncapturable(str(e), self.name) from None

    def _run(self, branch, body: Callable):
        if self.device.type == "cpu":
            ts = profiling.begin()
            # a branch's first run is its warm-up, as on the card
            held = self._outs.get(branch)
            with _body_of(self, "cpu" if held is not None else "warm"):
                out = body(branch)
            if held is None:
                held = self._outs[branch] = tree_map(torch.clone, out)
                self.captures += 1
                if ts:
                    profiling.end("step.capture", ts)
            else:
                for h, o in zip(leaves(held), leaves(out)):
                    h.copy_(o)
                if ts:
                    profiling.end("step.replay", ts)
            return held
        entry = self._graphs.get(branch)
        if entry is None:
            ts = profiling.begin()
            out = self._warm_and_capture(branch, body)
            if ts:
                profiling.end("step.capture", ts)
            return out
        graph, out, counts, kernels = entry
        with torch.cuda.device(self.device):
            ts = profiling.begin()
            graph.replay()
            if ts:
                profiling.end("step.replay", ts, kernels)
        _add_counters(counts)
        return out

    def _warm_and_capture(self, branch, body):
        dev = self.device
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side), _body_of(self, "warm"):
                out = body(branch)
            cur.wait_stream(side)
            for t in leaves(out):
                t.record_stream(cur)
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(dev)
            before = read_counters()
            # kept past the capture's end, so that its nodes can be counted
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            pool = torch.cuda.graph_pool_handle()
            try:
                with _no_gc(), _capturing(graph, pool, self._capture_stream), \
                        _body_of(self, "capture", pool):
                    gout = body(branch)
                kernels = graph_kernels(graph)
                graph.instantiate()
            except RuntimeError as e:
                free, total = torch.cuda.mem_get_info(dev)
                raise RuntimeError(
                    f"capturing a compiled step on {dev} failed (branch "
                    f"{branch!r}; {free / 2**30:.2f} of {total / 2**30:.2f} "
                    f"GiB free, {torch.cuda.memory_reserved(dev) / 2**30:.2f} "
                    f"reserved): {e}") from e
            counts = _counter_delta(before, read_counters())
            _restore_counters(before)
        self._graphs[branch] = (graph, gout, counts, kernels)
        self.captures += 1
        return out

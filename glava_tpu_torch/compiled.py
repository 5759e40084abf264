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
  graph; a value already on the device is copied device to device;
* **the donated state** (:meth:`Step.donate`): the step keeps the state
  in static buffers, the body updates them in place, and the call
  returns them. A state that is not the step's own is copied in;
* **branches**: a choice the host makes (whether new audio arrived, the
  pipe values a knob evaluates on the host) picks one graph of several.
  Each graph has its own memory pool, and every tensor that passes
  between graphs (the state, the inputs) is static, so replays in any
  order are safe. A change of the host values the graphs were captured
  with (``scope_key``) drops them, and the next call captures anew;
* **warm-up, then capture**: the first call of a branch runs the body
  eagerly on a side stream (that call's own result: it builds the
  kernels, makes their shared-memory opt-ins, fills the twiddle, cuFFT
  plan and colour caches), then captures the body; every later call
  replays the graph;
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
nothing. A failed capture or replay raises: nothing runs the eager step
in its place. A module whose passes read the host (a GLSL shader
module, whose interpreter's data-dependent loops read back, or a user
Python module, whose code is unknown) has no compiled step
(:func:`check_native`); the Engine runs its eager step and says so once
(:func:`note_eager`).
"""

from __future__ import annotations

import contextlib
import gc
import sys
import threading
from typing import Callable

import numpy as np
import torch

# the kernel launch counters a replay advances: (module of
# glava_tpu_torch.ops, attribute), an int or a dict of ints
COUNTERS = (("fused", "launches"), ("fused", "split_launches"),
            ("lookup", "launches"), ("lookup", "rowwise_launches"),
            ("latch", "launches"), ("raster", "launches"),
            ("smooth", "launches"))

# why a module kind keeps the eager step
EAGER_REASONS = {
    "shader": "a GLSL shader module: the interpreter's data-dependent loops "
              "read the device from the host",
    "python": "a user Python module: its code is unknown",
}

_ALIGN = 16     # bytes between static inputs in the flat buffer
_STAGING = 64 << 20   # pinned bytes a step's staging ring may hold
_NOTED: set = set()
_MODULES: dict = {}
# captures underway, and whether the garbage collector ran before them
_GC = {"captures": 0, "was_enabled": True, "lock": threading.Lock()}


def check_native(module) -> None:
    """Raise ``ValueError`` naming ``module`` (a ``ModuleBuild``) unless
    it is a native module, the kind whose step is captured."""
    if module.kind != "native":
        raise ValueError(
            f"module '{module.name}' has no compiled step "
            f"({EAGER_REASONS.get(module.kind, module.kind)}); run its eager "
            "step")


def note_eager(module) -> str:
    """Print once a process, to stderr, that ``module`` runs its eager
    step and why; returns the line."""
    line = (f"glava_tpu_torch: module '{module.name}' runs its eager step "
            f"({EAGER_REASONS.get(module.kind, module.kind)})")
    if module.name not in _NOTED:
        _NOTED.add(module.name)
        print(line, file=sys.stderr, flush=True)
    return line


# -- launch counters -----------------------------------------------------


def _counter_modules() -> dict:
    if not _MODULES:
        from glava_tpu_torch.ops import fused, latch, lookup, raster, smooth

        _MODULES.update(fused=fused, latch=latch, lookup=lookup,
                        raster=raster, smooth=smooth)
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


def pipe_key(rows: dict | None) -> tuple:
    """The host pipe rows (name -> float32 array) as a hashable key."""
    return tuple((k, a.shape, a.tobytes()) for k, a in sorted((rows or {})
                                                               .items()))


# the numpy type of each static input type
NP = {torch.float32: np.float32, torch.bool: np.bool_, torch.int32: np.int32}


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
    """One compiled step (module docstring): the owner's ``body(branch,
    scope)``, given to each :meth:`run`, reads :attr:`inputs` and the
    donated :attr:`state` and returns its outputs (a tensor, or a tuple
    or dict of them). ``dtypes`` names the per-call inputs and their
    types; their shapes are the first call's. ``keep`` returns what a
    graph reads that its owner may let go
    (``render.base.StreamColors.last``); each graph holds it."""

    def __init__(self, device, dtypes: dict, keep: Callable | None = None):
        self.device = torch.device(device)
        self.dtypes = dict(dtypes)
        self.keep = keep
        self.inputs: dict[str, torch.Tensor] = {}
        self.state = None
        self.captures = 0         # graphs captured so far
        self._layout: dict = {}   # name -> (offset, nbytes, shape)
        self._flat = None
        # [pinned staging buffer, the event after its copy, recorded?]
        self._stages: list = []
        self._calls = 0
        self._graphs: dict = {}   # branch -> (graph, outputs, counts, kept)
        self._outs: dict = {}     # branch -> static outputs (CPU)
        self._scope_key = None
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
        off = 0
        for name in self.dtypes:
            shape = tuple(shapes[name])
            nbytes = (int(np.prod(shape, dtype=np.int64))
                      * self.dtypes[name].itemsize)
            self._layout[name] = (off, nbytes, shape)
            off += -(-nbytes // _ALIGN) * _ALIGN
        self._flat = torch.zeros(max(off, _ALIGN), dtype=torch.uint8,
                                 device=self.device)
        for name, (o, n, shape) in self._layout.items():
            self.inputs[name] = (self._flat[o:o + n].view(self.dtypes[name])
                                 .view(shape))

    def load(self, **values) -> None:
        """Copy one call's inputs (every name of ``dtypes``) into the
        static buffers: host values (numbers, numpy arrays, CPU
        tensors) through one pinned staging buffer and one
        host-to-device copy, device tensors device to device; all
        before the replay, outside the graph."""
        if set(values) != set(self.dtypes):
            raise ValueError(f"a compiled step takes {sorted(self.dtypes)}, "
                             f"got {sorted(values)}")
        shapes = {k: tuple(np.shape(v)) if not isinstance(v, torch.Tensor)
                  else tuple(v.shape) for k, v in values.items()}
        if self._flat is None:
            self._allocate(shapes)
        for k, s in shapes.items():
            if s != self._layout[k][2]:
                raise ValueError(f"a compiled step keeps its first call's "
                                 f"shapes: {k} {s}, captured with "
                                 f"{self._layout[k][2]}")
        on_dev = {k: v for k, v in values.items()
                  if isinstance(v, torch.Tensor) and v.device.type != "cpu"}
        host = {k: v for k, v in values.items() if k not in on_dev}
        if self.device.type == "cpu":
            for k, v in values.items():
                self.inputs[k].copy_(v if isinstance(v, torch.Tensor) else
                                     torch.from_numpy(np.array(
                                         v, NP[self.dtypes[k]])))
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
            stage[1].synchronize()
        return stage

    # -- run: warm-up and capture, or replay -------------------------------

    def run(self, branch, body: Callable, scope=None, scope_key=None):
        """``body``'s outputs for ``branch`` on the loaded inputs:
        replayed from its graph on the card, after a first call that
        runs it eagerly and captures it; run eagerly on the CPU.
        ``scope`` is the host data the body reads (pipe rows); a new
        ``scope_key`` drops every graph."""
        if scope_key != self._scope_key:
            self._graphs.clear()
            self._outs.clear()
            self._scope_key = scope_key
        if self.device.type == "cpu":
            out = body(branch, scope)
            held = self._outs.get(branch)
            if held is None:
                held = self._outs[branch] = tree_map(torch.clone, out)
            else:
                for h, o in zip(leaves(held), leaves(out)):
                    h.copy_(o)
            return held
        entry = self._graphs.get(branch)
        if entry is None:
            return self._warm_and_capture(branch, body, scope)
        graph, out, counts, _kept = entry
        with torch.cuda.device(self.device):
            graph.replay()
        _add_counters(counts)
        return out

    def _warm_and_capture(self, branch, body, scope):
        dev = self.device
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = body(branch, scope)
            cur.wait_stream(side)
            for t in leaves(out):
                t.record_stream(cur)
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(dev)
            before = read_counters()
            graph = torch.cuda.CUDAGraph()
            try:
                # thread_local: another thread's engine may make calls
                # that a global capture forbids (an api.entry engine runs
                # on a thread of its own)
                with _no_gc(), torch.cuda.graph(
                        graph, stream=self._capture_stream,
                        capture_error_mode="thread_local"):
                    gout = body(branch, scope)
            except RuntimeError as e:
                free, total = torch.cuda.mem_get_info(dev)
                raise RuntimeError(
                    f"capturing a compiled step on {dev} failed (branch "
                    f"{branch!r}; {free / 2**30:.2f} of {total / 2**30:.2f} "
                    f"GiB free, {torch.cuda.memory_reserved(dev) / 2**30:.2f} "
                    f"reserved): {e}") from e
            counts = _counter_delta(before, read_counters())
            _restore_counters(before)
        kept = self.keep() if self.keep is not None else None
        self._graphs[branch] = (graph, gout, counts, kept)
        self.captures += 1
        return out

"""Module protocol and shared rasterization helpers.

Frame convention: **planar** — a 4-tuple of channel planes
``(r, g, b, a)``, each broadcastable to (H, W) float32, with **row 0
at the bottom** (GL fragment coordinates, matching the reference's
offscreen renders read with glReadPixels). The interleaved (H, W, 4)
RGBA array is materialized once per frame, by :func:`interleave` or
:func:`interleave_u8`; frame sinks flip to image convention when
exporting. Constant channels stay numpy across pass boundaries.

A module build produces a list of pass functions; pass ``k+1`` receives
pass ``k``'s output as ``prev`` (the reference's indirect FBO chain,
render.c:1556-1563, 2314-2330). A pass returns channel planes (a
3/4-tuple; alpha defaults to 1) or an interleaved (H, W, 4) tensor —
:func:`as_planes` normalizes.

A module whose build sets ``ModuleBuild.batched`` renders many streams
at once: its textures carry a leading stream axis (S, sz), its pipe
values (S, ...) rows, and its planes a leading S axis, broadcastable to
(S, H, W). The single-stream renderer runs such a module with S = 1.

A module built for a band of rows (``ModuleContext.rows``, a device's
band of a mesh's rows axis, ``parallel.mesh.row_bands``) that sets
``ModuleBuild.banded`` returns planes of the band's rows only; every
knob and centre still reads the whole frame's ``screen``. Its passes
that read ``prev`` at neighbouring rows take earlier passes computed
over the band widened by their taps (``ModuleContext.widened``),
clipped at the frame's real edges, so a band's inner edge equals the
whole frame's with no traffic between devices. A module that does not
set it renders the whole frame, and the renderer keeps the band.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from glava_tpu_torch import compiled
from glava_tpu_torch.config import glsl_expr
from glava_tpu_torch.config.state import RenderConfig
from glava_tpu_torch.ops import smoothing


# a frame: (r, g, b, a) channel planes, each a tensor, numpy array or
# scalar broadcastable to (H, W)
Planes = tuple


class PassInputs(NamedTuple):
    prev: Planes | None                 # previous pass output channel planes
    textures: dict[str, torch.Tensor]   # uniform name -> (sz,) texture
    time: Any                           # seconds (wraps at `timecycle`):
    #                                     a float, or a device tensor
    # pipe uniform name -> (S, ...) float32 values, one row a stream, on
    # the host or the device (batched modules only; None: every
    # `@name:default` takes its default)
    pipe: dict | None = None


PassFn = Callable[[PassInputs], Any]


def _np_like(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def as_planes(out) -> Planes:
    """Normalize a pass return value to 4 float32 channel planes
    (numpy channels stay numpy; tensors are cast to float32)."""
    if isinstance(out, (tuple, list)):
        comps = list(out)
        if len(comps) == 3:
            comps.append(1.0)
        if len(comps) != 4:
            raise TypeError(f"pass returned {len(comps)} channels")
    elif hasattr(out, "ndim") and out.ndim >= 3 and out.shape[-1] == 4:
        comps = [out[..., c] for c in range(4)]
    else:
        raise TypeError(f"pass returned {type(out).__name__}, expected "
                        "channel planes or an (H, W, 4) array")

    def cast(p):
        if _np_like(p):
            return np.asarray(p, np.float32)
        return p if p.dtype == torch.float32 else p.to(torch.float32)

    return tuple(cast(p) for p in comps)


def clip_planes(planes: Planes, lo: float = 0.0, hi: float = 1.0) -> Planes:
    """Per-channel [lo, hi] clamp, numpy-preserving."""
    return tuple(
        np.clip(p, np.float32(lo), np.float32(hi)) if _np_like(p)
        else torch.clamp(p, lo, hi)
        for p in planes
    )


def cut_rows(plane, r0: int, r1: int):
    """Rows [r0, r1) of a channel plane's row axis (axis -2); a plane
    broadcast over rows (a scalar, a row vector) stays as it is."""
    if np.ndim(plane) < 2 or plane.shape[-2] == 1:
        return plane
    return plane[..., r0:r1, :]


def device_plane(p, device) -> torch.Tensor:
    """A channel plane as a float32 tensor on ``device``: a host value
    through ``compiled.const`` (made once inside a compiled step)."""
    if isinstance(p, torch.Tensor):
        return p.to(device=device, dtype=torch.float32)
    return compiled.const(np.asarray(p, np.float32), device)


def _full_plane(p, shape: tuple, device) -> torch.Tensor:
    return device_plane(p, device).expand(shape)


def interleave(planes: Planes, h: int, w: int, device,
               batch: tuple = ()) -> torch.Tensor:
    """Channel planes -> the final (*batch, H, W, 4) float32 RGBA
    tensor (``batch`` = (S,) for a stream axis)."""
    shape = tuple(batch) + (h, w)
    return torch.stack([_full_plane(p, shape, device) for p in planes], dim=-1)


def interleave_u8(planes: Planes, h: int, w: int, device,
                  batch: tuple = ()) -> torch.Tensor:
    """Channel planes -> (*batch, H, W, 4) uint8 RGBA: round-half-even
    quantize per channel plane (``torch.round``, like ``jnp.round``),
    THEN interleave. Matches ``clip(round(f * 255))`` of the f32 frame
    bit-exactly."""
    shape = tuple(batch) + (h, w)
    comps = [
        torch.clamp(torch.round(_full_plane(p, shape, device) * 255.0), 0, 255)
        .to(torch.uint8)
        for p in planes
    ]
    return torch.stack(comps, dim=-1)


@dataclass
class ModuleContext:
    """Everything a module's build step needs."""

    cfg: RenderConfig
    env: glsl_expr.Env             # knob environment (module + user overrides)
    screen: tuple[int, int]        # (width, height) pixels
    sz: int                        # spectrum texture size (scaled bufsize)
    device: torch.device = torch.device("cpu")
    channels: int = 2              # 1 when `setmirror true` (render.c:289)
    # the band of frame rows [r0, r1) the module renders (row 0 at the
    # bottom); None: the whole frame
    rows: tuple[int, int] | None = None

    @property
    def band(self) -> tuple[int, int]:
        """The rows [r0, r1) to render: ``rows``, or the whole frame."""
        return self.rows if self.rows is not None else (0, self.screen[1])

    def widened(self, halo: int) -> tuple[int, int]:
        """The band widened by ``halo`` rows on each side, clipped at the
        frame's bottom and top rows."""
        r0, r1 = self.band
        return max(r0 - halo, 0), min(r1 + halo, self.screen[1])

    # -- knob readers ---------------------------------------------------

    def knob_f(self, name: str, default: float | None = None) -> float:
        if name not in self.env.defines and name not in self.env.variables:
            if default is None:
                raise KeyError(f"module knob '{name}' is not defined")
            return default
        return float(self.env.lookup(name))

    def knob_i(self, name: str, default: int | None = None) -> int:
        return int(self.knob_f(name, None if default is None else float(default)))

    def knob_raw(self, name: str, default: str | None = None) -> str:
        if name in self.env.defines:
            return self.env.defines[name].strip()
        if default is None:
            raise KeyError(f"module knob '{name}' is not defined")
        return default

    def color_fn(self, name: str) -> Callable[..., Any]:
        """Knob -> callable evaluating a (possibly per-pixel) color.

        The expression may reference runtime variables (``d``, ``pos``)
        which the caller binds as tensors; the result is a component
        tuple for :func:`color_planes`.
        """
        return lambda **vars: self.eval_color(name, None, **vars)

    def eval_color(self, name: str, pipe_values: dict | None,
                   reads: set | None = None, **vars):
        """Evaluate a colour knob with ``pipe_values`` (name -> value)
        bound over the load's own: ``@name:default`` takes the bound
        value, else its default expression. The names it read go into
        ``reads`` when given."""
        expr = self.env.defines.get(name)
        if expr is None:
            raise KeyError(f"module knob '{name}' is not defined")
        env = glsl_expr.Env(
            defines=self.env.defines,
            variables={**self.env.variables, **vars},
            pipe_values={**self.env.pipe_values, **(pipe_values or {})},
            reads=reads,
        )
        return glsl_expr.evaluate(expr, env)

    # -- spectrum sampling -----------------------------------------------

    @property
    def smooth_params(self) -> smoothing.SmoothParams:
        return smoothing.SmoothParams(
            factor=self.cfg.smooth_factor,
            sample_mode=self.knob_raw("SAMPLE_MODE", "average"),
            hybrid_weight=self.knob_f("SAMPLE_HYBRID_WEIGHT", 0.65),
            sample_scale=self.knob_f("SAMPLE_SCALE", 8.0),
            sample_range=self.knob_f("SAMPLE_RANGE", 0.9),
            round_formula=self.knob_raw("ROUND_FORMULA", "sinusoidal"),
        )

    def sampler(self, positions: np.ndarray) -> Callable[[torch.Tensor], torch.Tensor]:
        """smooth_audio at static positions in [0, 1] -> fn(tex) -> values.

        With the default smooth pass enabled, textures arrive
        pre-smoothed and sampling is the reference's texel fetch
        ``tex[round(idx * sz)]`` (smooth.glsl:61-63), indices baked in
        numpy; otherwise the full resample kernel is baked for these
        positions.
        """
        positions = np.asarray(positions, dtype=np.float64)
        if self.cfg.smooth_pass:
            idx = np.clip(
                np.round(positions * self.sz).astype(np.int64), 0, self.sz - 1
            )
            idx_t = torch.as_tensor(idx, device=self.device)
            return lambda tex: tex[..., idx_t]
        op = smoothing.build_resample(
            self.sz, positions.ravel(), self.smooth_params).on(self.device)
        shape = positions.shape
        return lambda tex: op(tex).reshape(*tex.shape[:-1], *shape)


@dataclass
class ModuleBuild:
    """A built module: ordered enabled passes, and the static table
    lookups (``ops.lookup.StaticLookup``) they run every frame.
    ``batched``: the passes take a leading stream axis (module
    docstring)."""

    name: str
    passes: list[PassFn] = field(default_factory=list)
    lookups: list = field(default_factory=list)
    batched: bool = False
    # the planes cover the context's band of rows only (module docstring)
    banded: bool = False
    # "native" (a built-in module), "shader" (the interpreter) or
    # "python" (a user Python module, whose passes run under
    # ``compiled.user_pass`` in a compiled step's body)
    kind: str = "python"

    def render(self, inputs: PassInputs) -> Planes:
        out = inputs.prev
        for fn in self.passes:
            if self.kind == "python":
                with compiled.user_pass(self.name):
                    planes = fn(inputs._replace(prev=out))
            else:
                planes = fn(inputs._replace(prev=out))
            out = as_planes(planes)
            # stage FBOs are 8-bit normalized color attachments
            # (render.c:543-556): every pass write clamps to [0, 1]
            out = clip_planes(out)
        return out


# ---------------------------------------------------------------------------
# shared pass pieces
# ---------------------------------------------------------------------------

def mul(x, y):
    """``x * y`` for channel planes; a numpy array times a tensor goes
    to the tensor's device (numpy does not multiply tensors)."""
    if isinstance(x, np.ndarray) and isinstance(y, torch.Tensor):
        x = torch.as_tensor(x, device=y.device)
    return x * y


def premultiply_pass(inputs: PassInputs) -> Planes:
    """util/premultiply.frag: rgb *= a."""
    r, g, b, a = inputs.prev
    return (mul(r, a), mul(g, a), mul(b, a), a)


def frag_coords(w: int, h: int, pixel_center_integer: bool,
                rows: tuple[int, int] | None = None,
                ) -> tuple[np.ndarray, np.ndarray]:
    """gl_FragCoord.x (W,) and .y (H,), or .y of the frame rows
    [r0, r1) only when ``rows`` is given — half-integer centers unless
    the pass declares ``layout(pixel_center_integer)``."""
    off = 0.0 if pixel_center_integer else 0.5
    r0, r1 = rows if rows is not None else (0, h)
    x = np.arange(w, dtype=np.float64) + off
    y = np.arange(r0, r1, dtype=np.float64) + off
    return x, y


def color_planes(value, device) -> list:
    """Evaluated color (component tuple / scalar) -> 4 broadcastable
    float32 channel components, numpy-preserving (concrete colors stay
    numpy; tensor components become float32 tensors on ``device``)."""
    if not isinstance(value, tuple):
        value = (value, value, value, value)
    if len(value) == 3:
        value = (*value, 1.0)
    return [
        np.asarray(c, np.float32) if _np_like(c)
        else torch.as_tensor(c, dtype=torch.float32, device=device)
        for c in value
    ]


def color_tensors(value, device) -> list[torch.Tensor]:
    """:func:`color_planes` with every component a float32 tensor on
    ``device`` (colors evaluated once at build time)."""
    return [torch.as_tensor(c, dtype=torch.float32, device=device)
            for c in color_planes(value, device)]


def f32_tensor(v, device) -> torch.Tensor:
    """A per-frame value (time, a pipe value; host or device) as a
    float32 tensor on ``device``: a device tensor passes through (a
    compiled step's static input)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def pipe_components(v: torch.Tensor, lead: int = 0, ndim: int = 0):
    """What ``@name`` evaluates to, from a value tensor whose first
    ``lead`` axes are kept (the stream axis): a float32 tensor (a vecN
    is a component tuple), each padded with ``ndim`` trailing unit axes
    so that it broadcasts against a knob's per-pixel variables."""
    pad = (1,) * ndim
    if v.ndim == lead:
        return v.reshape(tuple(v.shape) + pad)
    return tuple(v[..., i].reshape(tuple(v.shape[:lead]) + pad)
                 for i in range(v.shape[-1]))


class StreamColors:
    """Colour knobs evaluated from each stream's pipe values, on the
    device.

    A knob such as bars' ``COLOR`` (``@fg:mix(...)``) takes the pipe
    value ``fg`` where the step binds it and its default expression
    elsewhere; ``variables`` are the per-pixel values the knobs read
    (``d``). A call with the step's ``pipe`` (``PassInputs.pipe``: name
    -> (S, ...) values, a compiled step's static inputs) returns
    ``{knob: [r, g, b, a]}``, each component a float32 tensor on the
    device with a leading stream axis (S, or 1 when it reads no pipe
    value) and the knob's own shape, left-padded to ``ndim`` dimensions
    (passed through ``derive`` when given). The expressions run once
    for every stream, the stream axis leading: elementwise GLSL gives
    each stream the value it gets alone, as the JAX fleet's ``vmap``.
    They run every call only when a knob reads a bound name (the first
    call with a set of names finds out which it reads); otherwise the
    result depends on the load alone and is kept from the first call.
    """

    def __init__(self, ctx: ModuleContext, knobs: tuple, ndim: int = 2,
                 derive: Callable | None = None, **variables):
        self.ctx = ctx
        self.knobs = tuple(knobs)
        self.ndim = ndim
        self.derive = derive
        self.variables = {k: f32_tensor(v, ctx.device)
                          for k, v in variables.items()}
        self._fixed = None
        self._reads: dict = {}    # the names bound -> the names read

    def __call__(self, pipe: dict | None):
        pipe = pipe or {}
        names = frozenset(pipe)
        reads = self._reads.get(names)
        if reads is None:
            got: set = set()
            out = self._build(pipe, got)
            self._reads[names] = reads = names & got
            if not reads:
                self._fixed = out
            return out
        if not reads:
            if self._fixed is None:
                self._fixed = self._build({})
            return self._fixed
        return self._build({k: pipe[k] for k in reads})

    def _build(self, pipe: dict, reads: set | None = None):
        dev = self.ctx.device
        vals = {}
        for name, v in pipe.items():
            t = f32_tensor(v, dev)
            vals[name] = pipe_components(t, 1, self.ndim)
        out = {}
        for knob in self.knobs:
            comps = []
            for c in color_planes(self.ctx.eval_color(knob, vals, reads,
                                                      **self.variables), dev):
                c = device_plane(c, dev)
                if c.ndim <= self.ndim:
                    c = c.reshape((1,) * (self.ndim + 1 - c.ndim)
                                  + tuple(c.shape))
                comps.append(c)
            out[knob] = comps
        return self.derive(out) if self.derive is not None else out

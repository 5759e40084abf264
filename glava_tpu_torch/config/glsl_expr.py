"""Evaluator for GLSL constant/knob expressions.

Module behavior in the reference is parameterized by ``#define`` knobs
whose values are GLSL expressions — numbers (``4.5``, ``(PI / 2)``),
colors (``#3366b2``), vectors and per-pixel color formulas such as
``mix(#3366b2, #a0a0b2, clamp(d / GRADIENT, 0, 1))`` (e.g.
shaders/glava/bars.glsl:20-22). Since our rasterizers are torch programs,
those expressions are evaluated directly: identifiers resolve through
the knob environment (last-wins, like GLSL macro expansion at use
site), runtime variables (``d``, ``pos``) may be torch tensors, and vector
values are component tuples so swizzles (``COLOR.rgb``) and
constructors (``vec4(...)``) work naturally.

Also handles the ``@name:default`` pipe-bind syntax
(glava/glsl_ext.c:516-591): if ``name`` was bound with ``--pipe``, the
expression resolves to the live uniform value from the environment
(``_IN_name``), otherwise to the parsed default expression.

Backends: numpy and python values stay numpy/python (so concrete knob
math stays inspectable and bit-identical to the JAX package's numpy
path); any torch tensor operand moves the operation to torch, on that
tensor's device. numpy float64/int64 operands narrow to 32 bits when
they meet a tensor, as they do when they meet a jnp array.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from glava_tpu_torch import compiled

from glava_tpu_torch.config.colors import parse_color


class ExprError(ValueError):
    pass


# ---------------------------------------------------------------------------
# values: scalars are python floats / numpy / torch; vectors are tuples
# ---------------------------------------------------------------------------

def _is_vec(v) -> bool:
    return isinstance(v, tuple)


def _np_like(x) -> bool:
    return hasattr(x, "shape") or isinstance(x, (np.ndarray, np.generic))


class GlslMat:
    """Column-major GLSL matrix (mat2/mat3/mat4): ``cols`` is a tuple
    of N column tuples of N components. Components may be scalars or
    per-pixel planes, like vector components. GLSL's ``*`` is
    ALGEBRAIC for matrices (handled in the parser's ``mult``); ``+``,
    ``-`` and ``matrixCompMult`` are componentwise."""

    __slots__ = ("cols",)

    def __init__(self, cols):
        self.cols = tuple(tuple(c) for c in cols)

    @property
    def n(self) -> int:
        return len(self.cols)

    def row(self, i: int) -> tuple:
        return tuple(self.cols[k][i] for k in range(self.n))

    def __repr__(self):
        return f"GlslMat({self.cols!r})"


def _mat_dot(a, b):
    acc = None
    for x, y in zip(a, b):
        t = _map2(lambda p, q: p * q, lambda p, q: p * q, x, y)
        acc = t if acc is None else _map2(
            lambda p, q: p + q, lambda p, q: p + q, acc, t)
    return acc


def _mat_mul(a, b):
    """GLSL `*` with at least one matrix operand."""
    if isinstance(a, GlslMat) and isinstance(b, GlslMat):
        if a.n != b.n:
            raise ExprError("matrix size mismatch in mat * mat")
        n = a.n
        return GlslMat(tuple(
            tuple(_mat_dot(a.row(i), b.cols[j]) for i in range(n))
            for j in range(n)))
    if isinstance(a, GlslMat):
        if _is_vec(b):
            if len(b) != a.n:
                raise ExprError("mat * vec size mismatch")
            return tuple(_mat_dot(a.row(i), b) for i in range(a.n))
        return _mat_map(lambda c: _map2(
            lambda p, q: p * q, lambda p, q: p * q, c, b), a)
    # b is the matrix
    if _is_vec(a):
        if len(a) != b.n:
            raise ExprError("vec * mat size mismatch")
        return tuple(_mat_dot(a, b.cols[j]) for j in range(b.n))
    return _mat_map(lambda c: _map2(
        lambda p, q: p * q, lambda p, q: p * q, a, c), b)


def _mat_map(f, m: GlslMat) -> GlslMat:
    return GlslMat(tuple(tuple(f(c) for c in col) for col in m.cols))


def _mat_zip(f, fj, a: GlslMat, b: GlslMat) -> GlslMat:
    if a.n != b.n:
        raise ExprError("matrix size mismatch")
    return GlslMat(tuple(
        tuple(_map2(f, fj, x, y) for x, y in zip(ca, cb))
        for ca, cb in zip(a.cols, b.cols)))


def _host_concrete(x) -> bool:
    """True for host-concrete values (numpy / python scalars) — ops on
    these must stay numpy (one torch op makes them tensors and
    defeats the concrete fast paths)."""
    return isinstance(x, (np.ndarray, np.generic, bool, int, float))


def _host_concrete_tree(x) -> bool:
    if isinstance(x, tuple):
        return all(_host_concrete_tree(c) for c in x)
    if isinstance(x, GlslStruct):
        return all(_host_concrete_tree(c) for c in x.vals)
    if isinstance(x, GlslMat):
        return all(_host_concrete_tree(c) for col in x.cols for c in col)
    return _host_concrete(x)


def _as_i32(x):
    """Cast one operand of a GLSL integer op to int32 (GLSL's int()
    truncation for any float that sneaks in), numpy-preserving."""
    if isinstance(x, (np.ndarray, np.generic, int, bool, float)):
        return np.asarray(x).astype(np.int32)
    return _tensor(x).to(torch.int32)


def _int_map2(opf, a, b):
    """GLSL integer bit/shift op, componentwise with broadcasting;
    both operands cast to int32, int32 result. The same callable
    serves numpy and tensor operands (dunder ops work on both)."""
    def g(x, y):
        return opf(*_coerce(_as_i32(x), _as_i32(y)))

    return _map2(g, g, a, b)


def _map2(f, fj, a, b):
    """Binary op over scalars/vectors with GLSL broadcasting.

    Aggregates (structs, matrices, fixed arrays) map field/column/
    element-wise when BOTH sides are the same aggregate shape — needed
    by the per-pixel select chains in index_value/index_store, which
    `where` between two aggregate elements (e.g. a struct array
    indexed by a per-pixel index plane)."""
    if isinstance(a, GlslStruct) and isinstance(b, GlslStruct):
        if a.typename != b.typename:
            raise ExprError(
                f"struct type mismatch: {a.typename} vs {b.typename}")
        return GlslStruct(a.typename, a.names,
                          [_map2(f, fj, x, y)
                           for x, y in zip(a.vals, b.vals)])
    if isinstance(a, GlslMat) and isinstance(b, GlslMat):
        if a.n != b.n:
            raise ExprError("matrix size mismatch")
        return GlslMat(tuple(
            tuple(_map2(f, fj, x, y) for x, y in zip(ca, cb))
            for ca, cb in zip(a.cols, b.cols)))
    if isinstance(a, GlslArray) and isinstance(b, GlslArray):
        if len(a) != len(b):
            raise ExprError("array size mismatch")
        return GlslArray([_map2(f, fj, x, y)
                          for x, y in zip(a.elems, b.elems)])
    if _is_vec(a) and _is_vec(b):
        if len(a) != len(b):
            raise ExprError("vector size mismatch")
        return tuple(_map2(f, fj, x, y) for x, y in zip(a, b))
    if _is_vec(a):
        return tuple(_map2(f, fj, x, b) for x in a)
    if _is_vec(b):
        return tuple(_map2(f, fj, a, y) for y in b)
    if _np_like(a) or _np_like(b):
        a, b = _coerce(a, b)
        return fj(a, b)
    return f(a, b)


def _map1(f, fj, a):
    if _is_vec(a):
        return tuple(_map1(f, fj, x) for x in a)
    return fj(a) if _np_like(a) else f(a)


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def _tensor(x, device=None) -> torch.Tensor:
    """Value -> tensor; numpy float64/int64 narrow to 32 bits (the
    jnp-without-x64 promotion the JAX package's evaluator sees). Host
    data goes through ``compiled.const``: inside a compiled step's body
    it is uploaded once and reused."""
    if isinstance(x, torch.Tensor):
        return x
    if not isinstance(x, (bool, int, float)):
        x = np.asarray(x)
        if x.dtype == np.float64:
            x = x.astype(np.float32)
        elif x.dtype == np.int64:
            x = x.astype(np.int32)
        elif not x.flags.writeable:   # e.g. a broadcast view
            x = x.copy()
    t = compiled.const(x, device)
    if t.dtype == torch.float64:
        return t.to(torch.float32)
    if t.dtype == torch.int64:
        return t.to(torch.int32)
    return t


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _tensors(*xs) -> list:
    """Operands -> tensors on the device of the first tensor among them."""
    dev = _device_of(*xs)
    return [_tensor(x, dev) for x in xs]


def _coerce(a, b):
    """Mixed numpy/torch operands -> both tensors on the tensor's
    device (numpy and torch do not mix under python operators)."""
    if _is_torch(a) == _is_torch(b):
        return a, b
    dev = _device_of(a, b)
    if isinstance(a, (np.ndarray, np.generic)):
        a = _tensor(a, dev)
    if isinstance(b, (np.ndarray, np.generic)):
        b = _tensor(b, dev)
    return a, b


class _TorchOps:
    """The jnp-shaped subset of array functions the evaluator calls,
    on torch tensors. Operands that are not tensors join the device
    of the first tensor operand."""

    int32 = torch.int32
    float32 = torch.float32
    pi = math.pi

    @staticmethod
    def asarray(x, dtype=None):
        t = _tensor(x)
        if dtype is bool:
            dtype = torch.bool
        return t if dtype is None else t.to(dtype)

    @staticmethod
    def where(c, a, b):
        c, a, b = _tensors(c, a, b)
        return torch.where(c.to(torch.bool), a, b)

    @staticmethod
    def clip(v, lo, hi):
        if isinstance(lo, (int, float)) and isinstance(hi, (int, float)):
            return torch.clamp(_tensor(v), lo, hi)
        # torch.clamp takes both bounds as numbers or both as tensors
        v, lo, hi = _tensors(v, lo, hi)
        return torch.clamp(v, lo.to(v.dtype), hi.to(v.dtype))

    @staticmethod
    def stack(xs, axis=0):
        return torch.stack(list(xs), dim=axis)

    @staticmethod
    def broadcast_arrays(*xs):
        return torch.broadcast_tensors(*xs)


def _unary(fn):
    return staticmethod(lambda x: fn(_tensor(x)))


def _binary(fn):
    return staticmethod(lambda a, b: fn(*_tensors(a, b)))


for _name, _fn in {
    "abs": torch.abs, "sign": torch.sign, "floor": torch.floor,
    "ceil": torch.ceil, "trunc": torch.trunc, "round": torch.round,
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "exp2": torch.exp2, "log2": torch.log2, "isnan": torch.isnan,
    "isinf": torch.isinf,
}.items():
    setattr(_TorchOps, _name, _unary(_fn))
for _name, _fn in {
    "minimum": torch.minimum, "maximum": torch.maximum,
    "power": torch.pow, "arctan2": torch.atan2, "mod": torch.remainder,
}.items():
    setattr(_TorchOps, _name, _binary(_fn))


def _tnp():
    return _TorchOps


# ---------------------------------------------------------------------------
# fixed-size GLSL arrays (`float a[4]`, `vec2[](...)` constructors)
# ---------------------------------------------------------------------------

class GlslArray:
    """A fixed-size GLSL array value: a list of element values (scalars
    or component tuples)."""

    __slots__ = ("elems",)

    def __init__(self, elems):
        self.elems = list(elems)

    def __len__(self):
        return len(self.elems)

    def __repr__(self):  # pragma: no cover
        return f"GlslArray({self.elems!r})"


def index_value(v, idx):
    """``v[idx]`` on a GlslArray or vector. A Python-number index reads
    the element directly; a per-pixel index gathers via a select chain
    (element counts are small, so N-1 `where`s beat a real gather)."""
    if isinstance(v, GlslArray):
        elems = v.elems
    elif isinstance(v, GlslMat):
        elems = list(v.cols)   # m[j] is column j (GLSL column-major)
    elif _is_vec(v):
        elems = list(v)
    else:
        raise ExprError("cannot index a scalar with '[]'")
    if not elems:
        raise ExprError("cannot index an empty array")
    if not _np_like(idx):
        i = int(idx)
        if not 0 <= i < len(elems):
            raise ExprError(f"array index {i} out of range [0, {len(elems)})")
        return elems[i]
    tnp = _tnp()
    ii = tnp.asarray(idx, tnp.int32)
    acc = elems[0]
    for k in range(1, len(elems)):
        sel = lambda a, b, k=k: tnp.where(ii == k, b, a)
        acc = _map2(sel, sel, acc, elems[k])
    return acc


def index_store(v, idx, value):
    """Functional ``v[idx] = value`` on a GlslArray: returns a new
    GlslArray (mask-merging against the old value is the caller's job)."""
    if not isinstance(v, GlslArray):
        raise ExprError("cannot index-assign a non-array")
    elems = list(v.elems)
    if not _np_like(idx):
        i = int(idx)
        if not 0 <= i < len(elems):
            raise ExprError(f"array index {i} out of range [0, {len(elems)})")
        elems[i] = value
        return GlslArray(elems)
    tnp = _tnp()
    ii = tnp.asarray(idx, tnp.int32)
    out = []
    for k, old in enumerate(elems):
        sel = lambda o, n, k=k: tnp.where(ii == k, n, o)
        out.append(_map2(sel, sel, old, value))
    return GlslArray(out)


# ---------------------------------------------------------------------------
# user-declared GLSL structs (`struct Ray { vec2 o; vec2 d; };`)
# ---------------------------------------------------------------------------

class GlslStruct:
    """A GLSL struct value: field names (declaration order) + values
    (scalars, component tuples, mats, arrays, or nested structs)."""

    __slots__ = ("typename", "names", "vals")

    def __init__(self, typename, names, vals):
        self.typename = typename
        self.names = tuple(names)
        self.vals = tuple(vals)
        if len(self.names) != len(self.vals):
            raise ExprError(
                f"struct {typename} constructor takes {len(self.names)} "
                f"arguments, got {len(self.vals)}")

    def get(self, field: str):
        try:
            return self.vals[self.names.index(field)]
        except ValueError:
            raise ExprError(
                f"struct {self.typename} has no field '{field}' "
                f"(fields: {', '.join(self.names)})") from None

    def replace(self, field: str, value) -> "GlslStruct":
        try:
            i = self.names.index(field)
        except ValueError:
            raise ExprError(
                f"struct {self.typename} has no field '{field}' "
                f"(fields: {', '.join(self.names)})") from None
        vals = list(self.vals)
        vals[i] = value
        return GlslStruct(self.typename, self.names, vals)

    def __repr__(self):  # pragma: no cover
        return f"GlslStruct({self.typename}, {dict(zip(self.names, self.vals))!r})"


def _bool_all(parts):
    """AND-fold per-pixel booleans, numpy-preserving (logic_and's
    concreteness rule: one tensor operand promotes the fold to torch)."""
    out = parts[0]
    if not _host_concrete(out):
        out = _tnp().asarray(out, bool)
    else:
        out = np.asarray(out, bool)
    for p in parts[1:]:
        if _host_concrete(out) and _host_concrete(p):
            out = out & np.asarray(p, bool)
        else:
            o, q = _tensors(out, p)
            out = o.to(torch.bool) & q.to(torch.bool)
    return out


def _sel_tree(sel, a, b):
    """Per-pixel select over matching aggregate values (structs, mats,
    component tuples, scalars), fieldwise/elementwise recursive."""
    if isinstance(a, GlslStruct) or isinstance(b, GlslStruct):
        if not (isinstance(a, GlslStruct) and isinstance(b, GlslStruct)
                and a.typename == b.typename and a.names == b.names):
            raise ExprError("select needs two values of the same "
                            "struct type")
        return GlslStruct(a.typename, a.names,
                          [_sel_tree(sel, x, y)
                           for x, y in zip(a.vals, b.vals)])
    if isinstance(a, GlslMat) or isinstance(b, GlslMat):
        if not (isinstance(a, GlslMat) and isinstance(b, GlslMat)
                and a.n == b.n):
            raise ExprError("select needs two matrices of the same size")
        return _mat_zip(sel, sel, a, b)
    if isinstance(a, tuple) or isinstance(b, tuple):
        if not (isinstance(a, tuple) and isinstance(b, tuple)
                and len(a) == len(b)):
            raise ExprError("select on mismatched aggregate shapes")
        return tuple(_sel_tree(sel, x, y) for x, y in zip(a, b))
    return sel(a, b)


def _aggregate_eq(a, b):
    """GLSL aggregate `==`: a single per-pixel boolean, true iff every
    member is equal (GLSL 4.60 §5.9 — equality on vectors, matrices,
    arrays and structs yields a scalar bool, unlike equal())."""
    if isinstance(a, GlslStruct) or isinstance(b, GlslStruct):
        if not (isinstance(a, GlslStruct) and isinstance(b, GlslStruct)
                and a.typename == b.typename and a.names == b.names):
            raise ExprError("struct '==' needs two values of the same "
                            "struct type")
        parts = [_aggregate_eq(x, y) for x, y in zip(a.vals, b.vals)]
    elif isinstance(a, GlslMat) or isinstance(b, GlslMat):
        if not (isinstance(a, GlslMat) and isinstance(b, GlslMat)
                and a.n == b.n):
            raise ExprError("matrix '==' needs two matrices of the "
                            "same size")
        parts = [_aggregate_eq(x, y)
                 for ca, cb in zip(a.cols, b.cols)
                 for x, y in zip(ca, cb)]
    elif isinstance(a, tuple) and isinstance(b, tuple):
        if len(a) != len(b):
            raise ExprError("vector '==' needs equal sizes")
        parts = [_aggregate_eq(x, y) for x, y in zip(a, b)]
    else:
        return _map2(lambda x, y: x == y, lambda x, y: x == y, a, b)
    return _bool_all(parts)


def _exact1(jf, nf):
    """torch/numpy dispatch for BIT-EXACT unary ops (floor/trunc/abs/...):
    numpy inputs stay numpy so constant math stays host-side and
    inspectable. Only ops with identical IEEE results both ways
    dispatch like this;
    transcendentals use :func:`_approx1`/:func:`_approx2` (same
    dispatch, documented ulp drift)."""
    def g(x):
        if isinstance(x, (np.ndarray, np.generic)) and not _is_torch(x):
            return nf(x)
        return jf(x)

    return g


def _float_np(x):
    """Promote numpy integer inputs to float for transcendental math:
    GLSL has no integer transcendentals, and numpy raises on e.g.
    negative integer powers where torch silently evaluates."""
    if isinstance(x, (np.ndarray, np.generic)) \
            and np.issubdtype(np.asarray(x).dtype, np.integer):
        return np.asarray(x, np.float64)
    return x


def _approx1(jf, nf):
    """Like :func:`_exact1` but for TRANSCENDENTALS: numpy libm and
    the device's math library differ in ulps, so this is not bit-exact
    across the dispatch. Numpy inputs still go to numpy, which keeps
    constant coordinate math host-side and equal to the JAX package's
    numpy results."""
    def g(x):
        if isinstance(x, (np.ndarray, np.generic)) and not _is_torch(x):
            return nf(_float_np(x))
        return jf(x)

    return g


def _approx2(jf, nf):
    def g(a, b):
        if not _is_torch(a) and not _is_torch(b):
            return nf(_float_np(a), _float_np(b))
        return jf(a, b)

    return g


def _exact2(jf, nf):
    def g(a, b):
        if not _is_torch(a) and not _is_torch(b):
            return nf(a, b)
        return jf(*_coerce(a, b))

    return g


def _bitcast_j(x, to_float: bool):
    if to_float:
        return _tensor(x).to(torch.int32).view(torch.float32)
    return _tensor(x).to(torch.float32).view(torch.int32)


_BUILTIN_FUNCS: dict | None = None


def _builtin_funcs() -> dict[str, Callable]:
    """Builtin table, built ONCE (a _Parser is created per evaluated
    expression — rebuilding ~100 stateless closures each time was pure
    overhead). Returns a copy so callers may shadow."""
    global _BUILTIN_FUNCS
    if _BUILTIN_FUNCS is None:
        _BUILTIN_FUNCS = _make_builtin_funcs()
    return dict(_BUILTIN_FUNCS)


def _make_builtin_funcs() -> dict[str, Callable]:
    tnp = _tnp()

    def lift1(pyf, jf):
        return lambda x: _map1(pyf, jf, x)

    def _add(a, b):
        return _map2(lambda x, y: x + y, lambda x, y: x + y, a, b)

    def _mul(a, b):
        return _map2(lambda x, y: x * y, lambda x, y: x * y, a, b)

    def _rsub1(t):
        return _map1(lambda x: 1.0 - x, lambda x: 1.0 - x, t)

    def mix(a, b, t):
        return _add(_mul(a, _rsub1(t)), _mul(b, t))

    def clamp(x, lo, hi):
        def one(v):
            if _np_like(v) or _np_like(lo) or _np_like(hi):
                if not (_is_torch(v) or _is_torch(lo) or _is_torch(hi)):
                    return np.clip(v, lo, hi)
                return tnp.clip(v, lo, hi)
            return min(max(v, lo), hi)

        if _is_vec(x):
            return tuple(one(c) for c in x)
        return one(x)

    def _vecn(n):
        def ctor(*args):
            comps: list[Any] = []
            for a in args:
                if _is_vec(a):
                    comps.extend(a)
                else:
                    comps.append(a)
            if len(comps) == 1:
                comps = comps * n
            if len(comps) != n:
                raise ExprError(f"vec{n} constructor got {len(comps)} components")
            return tuple(comps)

        return ctor

    # int/bool vector constructors: component casts matching the
    # scalar int()/bool() builtins (float-everything design: int()
    # truncates but stays float-dtyped)
    _int_cast = lift1(lambda x: float(int(x)),
                      _exact1(tnp.trunc, np.trunc))

    def _bool_cast(x):
        if isinstance(x, (bool, int, float)):
            return bool(x)
        if isinstance(x, (np.ndarray, np.generic)):
            return np.asarray(x, bool)
        return _tnp().asarray(x, bool)

    def _cast_vecn(n, cast):
        base = _vecn(n)

        def ctor(*args):
            return tuple(cast(c) for c in base(*args))

        return ctor

    def _matn(n):
        def ctor(*args):
            if len(args) == 1 and isinstance(args[0], GlslMat):
                m = args[0]
                # matN(matM): overlap copied, identity elsewhere
                return GlslMat(tuple(
                    tuple(m.cols[j][i] if j < m.n and i < m.n
                          else (1.0 if i == j else 0.0)
                          for i in range(n))
                    for j in range(n)))
            comps: list[Any] = []
            for a in args:
                if isinstance(a, GlslMat):
                    raise ExprError(
                        "matrix argument in a mixed mat constructor")
                if _is_vec(a):
                    comps.extend(a)
                else:
                    comps.append(a)
            if len(comps) == 1:
                s = comps[0]
                return GlslMat(tuple(
                    tuple(s if i == j else 0.0 for i in range(n))
                    for j in range(n)))
            if len(comps) != n * n:
                raise ExprError(
                    f"mat{n} constructor got {len(comps)} components")
            return GlslMat(tuple(
                tuple(comps[j * n + i] for i in range(n))
                for j in range(n)))

        return ctor

    def _mat_transpose(m):
        if not isinstance(m, GlslMat):
            raise ExprError("transpose() needs a matrix")
        return GlslMat(tuple(m.row(i) for i in range(m.n)))

    def gmod(a, b):
        fj = _exact2(lambda x, y: x - y * tnp.floor(x / y),
                     lambda x, y: x - y * np.floor(x / y))
        return _map2(lambda x, y: x - y * math.floor(x / y), fj, a, b)

    def gmin(a, b):
        return _map2(min, _exact2(tnp.minimum, np.minimum), a, b)

    def gmax(a, b):
        return _map2(max, _exact2(tnp.maximum, np.maximum), a, b)

    def gpow(a, b):
        return _map2(lambda x, y: x ** y,
                     _approx2(tnp.power, np.power), a, b)

    def gatan(y, x=None):
        if x is None:
            return _map1(math.atan, _approx1(tnp.arctan, np.arctan), y)
        return _map2(math.atan2, _approx2(tnp.arctan2, np.arctan2), y, x)

    def gstep(edge, x):
        fj = _exact2(lambda e, v: tnp.asarray(v >= e, tnp.float32),
                     lambda e, v: (v >= e).astype(np.float32))
        return _map2(lambda e, v: 0.0 if v < e else 1.0, fj, edge, x)

    def gsmoothstep(e0, e1, x):
        def core(a, b, v):
            if any(map(_is_torch, (a, b, v))):
                a, b, v = _tensors(a, b, v)
                tt = torch.clamp((v - a) / (b - a), 0.0, 1.0)
            elif any(map(_np_like, (a, b, v))):
                tt = np.clip((v - a) / (b - a), 0.0, 1.0)
            else:
                tt = min(max((v - a) / (b - a), 0.0), 1.0)
            return tt * tt * (3.0 - 2.0 * tt)
        if _is_vec(x):
            return tuple(core(e0, e1, c) for c in x)
        return core(e0, e1, x)

    # -- geometric functions (GLSL 4.60 §8.5) ---------------------------
    def _dot(a, b):
        at = a if _is_vec(a) else (a,)
        bt = b if _is_vec(b) else (b,)
        if len(at) != len(bt):
            raise ExprError("dot() needs equal-size vectors")
        acc = None
        for x, y in zip(at, bt):
            t = _mul(x, y)
            acc = t if acc is None else _add(acc, t)
        return acc

    sqrt1 = lift1(math.sqrt, _approx1(tnp.sqrt, np.sqrt))

    def _length(a):
        return sqrt1(_dot(a, a))

    def _sub(a, b):
        return _map2(lambda x, y: x - y, lambda x, y: x - y, a, b)

    def _normalize(a):
        ln = _length(a)
        return _map2(lambda x, l: x / l, lambda x, l: x / l, a, ln)

    def _cross(a, b):
        if not (_is_vec(a) and _is_vec(b) and len(a) == 3 and len(b) == 3):
            raise ExprError("cross() needs two vec3s")
        return (
            _sub(_mul(a[1], b[2]), _mul(a[2], b[1])),
            _sub(_mul(a[2], b[0]), _mul(a[0], b[2])),
            _sub(_mul(a[0], b[1]), _mul(a[1], b[0])),
        )

    def _reflect(i, n):
        # I - 2 * dot(N, I) * N
        return _sub(i, _mul(_mul(2.0, _dot(n, i)), n))

    def _where_lt0(c, a_c, b_c):
        """a_c where c < 0 else b_c, scalar/plane dispatch."""
        if not _np_like(c):
            return a_c if c < 0.0 else b_c
        if _is_torch(c) or _is_torch(a_c) or _is_torch(b_c):
            return tnp.where(c < 0.0, a_c, b_c)
        return np.where(c < 0.0, a_c, b_c)

    def _refract(i, n, eta):
        d = _dot(n, i)
        k = _sub(1.0, _mul(_mul(eta, eta), _sub(1.0, _mul(d, d))))
        r = _sub(_mul(eta, i),
                 _mul(_add(_mul(eta, d), sqrt1(gmax(k, 0.0))), n))
        if _is_vec(r):
            return tuple(_where_lt0(k, 0.0, c) for c in r)
        return _where_lt0(k, 0.0, r)

    def _faceforward(nv, i, nref):
        d = _dot(nref, i)
        neg = _map1(lambda x: -x, lambda x: -x, nv)
        nt = nv if _is_vec(nv) else (nv,)
        gt = neg if _is_vec(neg) else (neg,)
        out = tuple(_where_lt0(d, a_c, b_c) for a_c, b_c in zip(nt, gt))
        return out if _is_vec(nv) else out[0]

    # -- vector relational (§8.7): componentwise bvec results -----------
    def _rel(op):
        def f(a, b):
            if not (_is_vec(a) and _is_vec(b) and len(a) == len(b)):
                raise ExprError("vector relational needs equal-size vectors")
            return tuple(_map2(op, op, x, y) for x, y in zip(a, b))
        return f

    def _as_bool(c):
        if not _np_like(c):
            return bool(c)
        return (np.asarray(c, bool) if _host_concrete(c)
                else tnp.asarray(c, bool))

    def _bvec_fold(name, combine_np, combine_py):
        def fold(v):
            if not _is_vec(v):
                raise ExprError(f"{name}() needs a bvec")
            acc = None
            for c in v:
                cb = _as_bool(c)
                if acc is None:
                    acc = cb
                elif _np_like(acc) or _np_like(cb):
                    acc = combine_np(acc, cb)
                else:
                    acc = combine_py(acc, cb)
            return acc
        return fold

    _any = _bvec_fold("any", lambda a, b: a | b, lambda a, b: a or b)
    _all = _bvec_fold("all", lambda a, b: a & b, lambda a, b: a and b)

    def _not(v):
        if not _is_vec(v):
            raise ExprError("not() needs a bvec")
        return tuple((not c) if not _np_like(c) else ~_as_bool(c)
                     for c in v)

    return {
        "mix": mix,
        "clamp": clamp,
        "vec2": _vecn(2),
        "vec3": _vecn(3),
        "vec4": _vecn(4),
        "mat2": _matn(2),
        "mat3": _matn(3),
        "mat4": _matn(4),
        "transpose": _mat_transpose,
        "matrixCompMult": lambda a, b: _mat_zip(
            lambda x, y: x * y, lambda x, y: x * y, a, b),
        "min": gmin,
        "max": gmax,
        "abs": lift1(abs, _exact1(tnp.abs, np.abs)),
        "sign": lift1(lambda x: (x > 0) - (x < 0),
                      _exact1(tnp.sign, np.sign)),
        "floor": lift1(math.floor, _exact1(tnp.floor, np.floor)),
        "ceil": lift1(math.ceil, _exact1(tnp.ceil, np.ceil)),
        "round": lift1(round, _exact1(tnp.round, np.round)),
        "fract": lift1(lambda x: x - math.floor(x),
                       _exact1(lambda x: x - tnp.floor(x),
                               lambda x: x - np.floor(x))),
        "mod": gmod,
        "pow": gpow,
        "sqrt": lift1(math.sqrt, _approx1(tnp.sqrt, np.sqrt)),
        "exp": lift1(math.exp, _approx1(tnp.exp, np.exp)),
        "log": lift1(math.log, _approx1(tnp.log, np.log)),
        "sin": lift1(math.sin, _approx1(tnp.sin, np.sin)),
        "cos": lift1(math.cos, _approx1(tnp.cos, np.cos)),
        "tan": lift1(math.tan, _approx1(tnp.tan, np.tan)),
        "atan": gatan,
        "step": gstep,
        "smoothstep": gsmoothstep,
        "float": lift1(float, lambda x: x),
        "int": lift1(lambda x: float(int(x)),
                     _exact1(tnp.trunc, np.trunc)),
        "uint": lift1(lambda x: float(int(x)),
                      _exact1(tnp.trunc, np.trunc)),
        "ivec2": _cast_vecn(2, _int_cast),
        "ivec3": _cast_vecn(3, _int_cast),
        "ivec4": _cast_vecn(4, _int_cast),
        "bvec2": _cast_vecn(2, _bool_cast),
        "bvec3": _cast_vecn(3, _bool_cast),
        "bvec4": _cast_vecn(4, _bool_cast),
        "uvec2": _cast_vecn(2, _int_cast),
        "uvec3": _cast_vecn(3, _int_cast),
        "uvec4": _cast_vecn(4, _int_cast),
        # geometric (§8.5)
        "length": _length,
        "distance": lambda a, b: _length(_sub(a, b)),
        "dot": _dot,
        "normalize": _normalize,
        "cross": _cross,
        "reflect": _reflect,
        "refract": _refract,
        "faceforward": _faceforward,
        # vector relational (§8.7)
        "greaterThan": _rel(lambda x, y: x > y),
        "greaterThanEqual": _rel(lambda x, y: x >= y),
        "lessThan": _rel(lambda x, y: x < y),
        "lessThanEqual": _rel(lambda x, y: x <= y),
        "equal": _rel(lambda x, y: x == y),
        "notEqual": _rel(lambda x, y: x != y),
        "any": _any,
        "all": _all,
        "not": _not,
        # remaining common transcendentals / rounding (§8.1-8.3)
        "asin": lift1(math.asin, _approx1(tnp.arcsin, np.arcsin)),
        "acos": lift1(math.acos, _approx1(tnp.arccos, np.arccos)),
        "sinh": lift1(math.sinh, _approx1(tnp.sinh, np.sinh)),
        "cosh": lift1(math.cosh, _approx1(tnp.cosh, np.cosh)),
        "tanh": lift1(math.tanh, _approx1(tnp.tanh, np.tanh)),
        "exp2": lift1(lambda x: 2.0 ** x, _approx1(tnp.exp2, np.exp2)),
        "log2": lift1(math.log2, _approx1(tnp.log2, np.log2)),
        "inversesqrt": lift1(
            lambda x: 1.0 / math.sqrt(x),
            _approx1(lambda x: 1.0 / tnp.sqrt(x),
                     lambda x: 1.0 / np.sqrt(x))),
        "trunc": lift1(math.trunc, _exact1(tnp.trunc, np.trunc)),
        "roundEven": lift1(round,  # python round IS round-half-even
                           _exact1(tnp.round, np.round)),
        "radians": lift1(math.radians,
                         _exact1(lambda x: x * (tnp.pi / 180.0),
                                 lambda x: x * (np.pi / 180.0))),
        "degrees": lift1(math.degrees,
                         _exact1(lambda x: x * (180.0 / tnp.pi),
                                 lambda x: x * (180.0 / np.pi))),
        "isnan": lift1(lambda x: x != x, _exact1(tnp.isnan, np.isnan)),
        "isinf": lift1(lambda x: x in (float("inf"), float("-inf")),
                       _exact1(tnp.isinf, np.isinf)),
        # bit casts (§8.3) — exact by definition
        "floatBitsToInt": lift1(
            lambda x: int(np.float32(x).view(np.int32)),
            _exact1(lambda x: _bitcast_j(x, False),
                    lambda x: np.asarray(x, np.float32).view(np.int32))),
        "intBitsToFloat": lift1(
            lambda x: float(np.int32(int(x)).view(np.float32)),
            _exact1(lambda x: _bitcast_j(x, True),
                    lambda x: np.asarray(x, np.int32).view(np.float32))),
    }


_SWIZZLE = {"r": 0, "g": 1, "b": 2, "a": 3, "x": 0, "y": 1, "z": 2, "w": 3,
            "s": 0, "t": 1, "p": 2, "q": 3}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<color>\#[0-9a-fA-F]{1,8})
  | (?P<num>0[xX][0-9a-fA-F]+[uU]?|(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?[fFuU]?)
  | (?P<bind>@[A-Za-z_][A-Za-z0-9_]*:?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\+\+|--|\+=|-=|\*=|/=|%=|<<=|>>=|&=|\|=|\^=|==|!=|<<|>>|<=|>=|&&|\|\||[-+*/%(),.<>?:!={};\[\]~^&|])
    """,
    re.X,
)


def tokenize(src: str) -> list[tuple[str, str]]:
    toks: list[tuple[str, str]] = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise ExprError(f"unexpected character {src[i]!r} in expression {src!r}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        toks.append((kind, m.group()))
    toks.append(("end", ""))
    return toks


def tokenize_lines(src: str, base: int = 0
                   ) -> tuple[list[tuple[str, str]], list[int]]:
    """:func:`tokenize` plus a parallel per-token line-number list
    (1-based, offset by ``base``) — the shader interpreter threads it
    through statement parsing so errors cite source locations."""
    toks: list[tuple[str, str]] = []
    lines: list[int] = []
    i, ln = 0, 1
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise ExprError(
                f"unexpected character {src[i]!r} in expression {src!r}")
        nl = src.count("\n", i, m.end())
        i = m.end()
        kind = m.lastgroup
        tok_ln = ln
        ln += nl
        if kind == "ws":
            continue
        toks.append((kind, m.group()))
        lines.append(tok_ln + base)
    toks.append(("end", ""))
    lines.append(ln + base)
    return toks, lines


@dataclass
class Env:
    """Evaluation environment for knob expressions."""

    defines: dict[str, str] = field(default_factory=dict)
    variables: dict[str, Any] = field(default_factory=dict)  # runtime values
    pipe_values: dict[str, Any] = field(default_factory=dict)  # live --pipe uniforms
    functions: dict[str, Any] = field(default_factory=dict)  # extra callables
    # when a set: the names of pipe_values an evaluation read go in
    reads: set | None = None
    _cache: dict[str, Any] = field(default_factory=dict)
    _expanding: set = field(default_factory=set)

    def lookup(self, name: str):
        if name in self.variables:
            return self.variables[name]
        if name in self.defines:
            if name in self._expanding:
                raise ExprError(f"recursive macro '{name}'")
            self._expanding.add(name)
            try:
                val = evaluate(self.defines[name], self)
            finally:
                self._expanding.discard(name)
            return val
        raise ExprError(f"undefined identifier '{name}'")


class _Parser:
    def __init__(self, toks: list[tuple[str, str]], env: Env):
        self.toks = toks
        self.pos = 0
        self.env = env
        self.funcs = _builtin_funcs()

    def peek(self):
        return self.toks[self.pos]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, val):
        k, v = self.next()
        if v != val:
            raise ExprError(f"expected {val!r}, got {v!r}")

    # precedence climbing
    def parse(self):
        v = self.ternary()
        if self.peek()[0] != "end":
            raise ExprError(f"trailing tokens at {self.peek()[1]!r}")
        return v

    def ternary(self):
        cond = self.logic_or()
        if self.peek()[1] == "?":
            self.next()
            a = self.ternary()
            self.expect(":")
            b = self.ternary()
            if _np_like(cond):  # per-pixel select
                # concrete operands stay NUMPY: a torch.where would
                # turn them into tensors
                if (_host_concrete(cond) and _host_concrete_tree(a)
                        and _host_concrete_tree(b)):
                    def sel(x, y):
                        return np.where(cond, x, y)
                else:
                    tnp = _tnp()

                    def sel(x, y):
                        return tnp.where(cond, x, y)

                if isinstance(a, (GlslStruct, GlslMat)) \
                        or isinstance(b, (GlslStruct, GlslMat)):
                    # _sel_tree validates struct/matrix shape matches
                    return _sel_tree(sel, a, b)
                if _is_vec(a) or _is_vec(b):
                    at = a if _is_vec(a) else (a,) * len(b)
                    bt = b if _is_vec(b) else (b,) * len(at)
                    return tuple(sel(x, y) for x, y in zip(at, bt))
                return sel(a, b)
            return a if _truthy(cond) else b
        return cond

    def logic_or(self):
        v = self.logic_and()
        while self.peek()[1] == "||":
            self.next()
            rhs = self.logic_and()
            if _np_like(v) or _np_like(rhs):
                if _host_concrete(v) and _host_concrete(rhs):
                    v = np.asarray(v, bool) | np.asarray(rhs, bool)
                else:
                    a, b = _tensors(v, rhs)
                    v = a.to(torch.bool) | b.to(torch.bool)
            else:
                v = _truthy(v) or _truthy(rhs)
        return v

    def logic_and(self):
        v = self.bit_or()
        while self.peek()[1] == "&&":
            self.next()
            rhs = self.bit_or()
            if _np_like(v) or _np_like(rhs):
                if _host_concrete(v) and _host_concrete(rhs):
                    v = np.asarray(v, bool) & np.asarray(rhs, bool)
                else:
                    a, b = _tensors(v, rhs)
                    v = a.to(torch.bool) & b.to(torch.bool)
            else:
                v = _truthy(v) and _truthy(rhs)
        return v

    # GLSL/C integer bit ops: precedence & > ^ > | (all between
    # equality and &&); shifts bind tighter than relational
    def bit_or(self):
        v = self.compare()
        while self.peek()[1] == "|":
            self.next()
            v = _int_map2(lambda a, b: a | b, v, self.compare())
        return v

    def bit_xor(self):
        # GLSL places ^ between & and |; compare() calls bit_xor so
        # `a & b ^ c | d` groups as ((a&b)^c)|d
        v = self.bit_and()
        while self.peek()[1] == "^":
            self.next()
            v = _int_map2(lambda a, b: a ^ b, v, self.bit_and())
        return v

    def bit_and(self):
        v = self.equality()
        while self.peek()[1] == "&":
            self.next()
            v = _int_map2(lambda a, b: a & b, v, self.equality())
        return v

    def compare(self):
        return self.bit_xor()

    def equality(self):
        # GLSL/C: relational binds tighter than equality, so
        # `a == b < c` parses as `a == (b < c)`
        v = self.relational()
        while self.peek()[1] in ("==", "!="):
            op = self.next()[1]
            rhs = self.relational()
            aggregate = (isinstance(v, (GlslStruct, GlslMat))
                         or isinstance(rhs, (GlslStruct, GlslMat))
                         or (isinstance(v, tuple) and isinstance(rhs, tuple)))
            if aggregate:
                eq = _aggregate_eq(v, rhs)
                if op == "==":
                    v = eq
                elif _host_concrete(eq):
                    v = ~np.asarray(eq, bool)
                else:
                    v = ~_tnp().asarray(eq, bool)
                continue
            f = ((lambda a, b: a == b) if op == "=="
                 else (lambda a, b: a != b))
            v = _map2(f, f, v, rhs)
        return v

    def relational(self):
        v = self.shift_expr()
        while self.peek()[1] in ("<", ">", "<=", ">="):
            op = self.next()[1]
            rhs = self.shift_expr()
            if isinstance(v, (GlslStruct, GlslMat)) \
                    or isinstance(rhs, (GlslStruct, GlslMat)):
                raise ExprError(
                    f"'{op}' is not defined for aggregate types")
            table = {
                "<": lambda a, b: a < b,
                ">": lambda a, b: a > b,
                "<=": lambda a, b: a <= b,
                ">=": lambda a, b: a >= b,
            }
            f = table[op]
            v = _map2(f, f, v, rhs)
        return v

    def shift_expr(self):
        v = self.additive()
        while self.peek()[1] in ("<<", ">>"):
            op = self.next()[1]
            rhs = self.additive()
            v = _int_map2((lambda a, b: a << b) if op == "<<"
                          else (lambda a, b: a >> b), v, rhs)
        return v

    def additive(self):
        v = self.mult()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            rhs = self.mult()
            f = ((lambda a, b: a + b) if op == "+"
                 else (lambda a, b: a - b))
            if isinstance(v, GlslMat) or isinstance(rhs, GlslMat):
                if not (isinstance(v, GlslMat)
                        and isinstance(rhs, GlslMat)):
                    raise ExprError(f"matrix {op} non-matrix")
                v = _mat_zip(f, f, v, rhs)
            else:
                v = _map2(f, f, v, rhs)
        return v

    def mult(self):
        v = self.unary()
        while self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            rhs = self.unary()
            if isinstance(v, GlslMat) or isinstance(rhs, GlslMat):
                if op == "*":
                    v = _mat_mul(v, rhs)
                elif op == "/":
                    f = lambda a, b: a / b  # noqa: E731
                    if isinstance(v, GlslMat) and isinstance(rhs, GlslMat):
                        v = _mat_zip(f, f, v, rhs)  # componentwise
                    elif isinstance(v, GlslMat):
                        v = _mat_map(lambda c: _map2(f, f, c, rhs), v)
                    else:
                        v = _mat_map(lambda c: _map2(f, f, v, c), rhs)
                else:
                    raise ExprError("'%' is not defined for matrices")
            elif op == "*":
                v = _map2(lambda a, b: a * b, lambda a, b: a * b, v, rhs)
            elif op == "/":
                v = _map2(lambda a, b: a / b, lambda a, b: a / b, v, rhs)
            else:
                tnp = _tnp()
                v = _map2(lambda a, b: math.fmod(a, b), tnp.mod, v, rhs)
        return v

    def unary(self):
        k, val = self.peek()
        if val == "-":
            self.next()
            v = self.unary()
            if isinstance(v, GlslMat):
                return _mat_map(
                    lambda c: _map1(lambda x: -x, lambda x: -x, c), v)
            return _map1(lambda x: -x, lambda x: -x, v)
        if val == "+":
            self.next()
            return self.unary()
        if val == "!":
            self.next()
            v = self.unary()
            if _np_like(v):
                if _host_concrete(v):
                    return ~np.asarray(v, bool)
                return ~_tnp().asarray(v, bool)
            return not _truthy(v)
        if val == "~":  # integer bitwise complement
            self.next()
            v = self.unary()
            if _is_vec(v):
                return tuple(~_as_i32(c) for c in v)
            return ~_as_i32(v)
        return self.postfix()

    def postfix(self):
        v = self.primary()
        while True:
            nxt = self.peek()[1]
            if nxt == ".":
                self.next()
                k, name = self.next()
                if k != "ident":
                    raise ExprError("expected swizzle after '.'")
                if isinstance(v, GlslStruct):
                    v = v.get(name)
                    continue
                if not _is_vec(v):
                    raise ExprError(f"cannot swizzle non-vector with '.{name}'")
                idxs = [_SWIZZLE[c] for c in name]
                v = v[idxs[0]] if len(idxs) == 1 else tuple(v[i] for i in idxs)
            elif nxt == "[":
                self.next()
                idx = self.ternary()
                self.expect("]")
                v = index_value(v, idx)
            else:
                break
        return v

    def primary(self):
        k, val = self.next()
        if k == "num":
            if val[:2] in ("0x", "0X"):
                # hex digits include f/F — only strip the uint suffix
                return float(int(val.rstrip("uU"), 16))
            return float(val.rstrip("fFuU"))
        if k == "color":
            c = parse_color(val[1:])
            if c is None:
                raise ExprError(f"invalid color literal {val!r}")
            return c
        if k == "bind":
            return self._bind(val)
        if val == "(":
            v = self.ternary()
            self.expect(")")
            return v
        if k == "ident":
            if val == "true":
                return True
            if val == "false":
                return False
            if self.peek()[1] == "[" and val in (
                "float", "int", "bool", "uint", "vec2", "vec3", "vec4",
                "ivec2", "ivec3", "ivec4"
            ):
                # array constructor: TYPE[size?](e0, e1, ...)
                self.next()
                declared = None
                if self.peek()[1] != "]":
                    declared = self.ternary()
                self.expect("]")
                self.expect("(")
                elems = []
                if self.peek()[1] != ")":
                    elems.append(self.ternary())
                    while self.peek()[1] == ",":
                        self.next()
                        elems.append(self.ternary())
                self.expect(")")
                if declared is not None and elems \
                        and int(declared) != len(elems):
                    raise ExprError(
                        f"array constructor declares {int(declared)} "
                        f"elements but got {len(elems)}"
                    )
                if declared is not None and not elems:
                    elems = [0.0] * int(declared)
                return GlslArray(elems)
            if self.peek()[1] == "(":
                self.next()
                args = []
                arg_toks = []
                if self.peek()[1] != ")":
                    start = self.pos
                    args.append(self.ternary())
                    arg_toks.append(self.toks[start:self.pos])
                    while self.peek()[1] == ",":
                        self.next()
                        start = self.pos
                        args.append(self.ternary())
                        arg_toks.append(self.toks[start:self.pos])
                self.expect(")")
                fn = self.env.functions.get(val) or self.funcs.get(val)
                if fn is None:
                    raise ExprError(f"unknown function '{val}'")
                needs = getattr(fn, "_needs_lvalues", None)
                if needs is not None:
                    # out/inout params: hand the callee each such
                    # argument's token slice so it can write back
                    lv = {i: arg_toks[i] for i in needs
                          if i < len(arg_toks)}
                    return fn(*args, _lvalues=lv)
                return fn(*args)
            return self.env.lookup(val)
        raise ExprError(f"unexpected token {val!r}")

    def _bind(self, tok: str):
        """@name or @name:default (glsl_ext.c:516-591)."""
        name = tok[1:].rstrip(":")
        has_default = tok.endswith(":")
        if name in self.env.pipe_values:
            if has_default:
                self._skip_default()
            if self.env.reads is not None:
                self.env.reads.add(name)
            return self.env.pipe_values[name]
        if not has_default:
            raise ExprError(
                f"Unexpected `--pipe` binding name '@{name}'. "
                "Try assigning a default or binding the value."
            )
        return self.ternary()

    def _skip_default(self):
        """Consume the default expression without keeping its value."""
        saved = self.pos
        try:
            self.ternary()  # defaults are pure; evaluate and discard
        except ExprError:
            self.pos = saved
            depth = 0  # fall back: skip a balanced-paren token run
            while True:
                k, v = self.peek()
                if k == "end":
                    break
                if v == "(":
                    depth += 1
                elif v == ")":
                    if depth == 0:
                        break
                    depth -= 1
                elif v == "," and depth == 0:
                    break
                self.next()


def _truthy(v) -> bool:
    if _is_vec(v):
        raise ExprError("vector used in boolean context")
    if _np_like(v):
        return bool(v)
    return bool(v)


def evaluate(src: str, env: Env | None = None):
    """Evaluate one knob expression to a scalar / bool / component tuple."""
    env = env or Env()
    toks = tokenize(src)
    return _Parser(toks, env).parse()


def to_rgba(value, tnp=None):
    """Component tuple / scalar -> stacked (..., 4) float32 tensor."""
    tnp = tnp or _tnp()
    if not _is_vec(value):
        value = (value, value, value, value)
    if len(value) == 3:
        value = (*value, 1.0)
    dev = _device_of(*value)
    comps = [_tensor(c, dev).to(torch.float32) for c in value]
    comps = tnp.broadcast_arrays(*comps)
    return tnp.stack(comps, axis=-1)

"""Restricted GLSL fragment-shader interpreter -> a torch rasterizer.

GLava's module system is user-extensible: a directory of numbered
fragment shaders in the config root becomes a module
(render.c:1488-1597). This interpreter runs a documented subset of
GLSL fragment shaders as vectorized torch over the (H, W) pixel grid,
the port of ``glava_tpu/config/glsl_shader.py``:

* statements: declarations with initializers, assignments (compound
  ops, swizzled and nested lvalues), ``if``/``else``, ``switch`` with
  fallthrough, ``for``/``while``/``do`` loops with ``break`` and
  ``continue``, early ``return``, ``discard``, helper functions (in,
  out, inout params), structs, fixed-size arrays and matrices;
* control flow is vectorized: an ``if`` masks both branches, ``return``
  retires pixels;
* builtins: ``gl_FragCoord``, the ``screen``/``audio_sz``/``time``
  uniforms, ``texture``/``texelFetch``/``textureSize`` on the 1-D audio
  textures and on ``prev`` (the previous pass), ``smooth_audio`` /
  ``smooth_audio_adj``, ``dFdx``/``dFdy``/``fwidth`` (coarse 2x2 quads)
  and everything ``glsl_expr`` evaluates.

Host-known values stay numpy and runtime data is a ``torch.Tensor`` (the
JAX package's concrete-versus-traced split): coordinate math on
``gl_FragCoord`` stays inspectable, and the fetch routes below read its
structure. The route follows from the shader; the kernel from the
tensor's device (CPU tensors take each kernel's plain version):

* a constant-shift ``texelFetch(prev, ...)`` is a slice;
* a fetch at a uniform-step walk variable is a row-shifted slice;
* a first-hit walk loop becomes one key scan (``ops.latch.latch_scan``,
  C = 0), and a fetch at its result the latch scan with C = 4;
* other fetches at a walk result and column-aligned fetches at a
  runtime row use ``ops.lookup.rowwise_lookup`` (C = 4);
* 1-D texel fetches use ``ops.lookup`` (``StaticLookup`` for numpy
  index planes, ``fetch_1d`` for runtime ones).

Data-dependent loops (``ops.graph_while``) run until no pixel is
active or the fuel cap ``4*(H+W)+4096`` (``GLAVA_TPU_WHILE_FUEL``) is
reached: eagerly, one host synchronisation per iteration, or inside a
compiled step's capture as a conditional while node of the graph, with
no host read (their state in buffers made before the loop, a walk's
row offset a device int32). Exhaustion counts the truncated pixels on
the device; the eager step reports them at once, a compiled step's
caller with :func:`fuel_check` (a stderr line at most once a second,
``GLAVA_TPU_WHILE_FUEL_WARN=0`` silences it; raises under
``GLAVA_TPU_WHILE_FUEL_STRICT=1``). Host values a frame turns into
tensors go through ``compiled.const`` (uploaded once inside a compiled
step). Unsupported constructs raise a clear error at load time.
"""

from __future__ import annotations

import collections
import hashlib
import math
import os
import re
import sys
import time as _time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from glava_tpu_torch import compiled
from glava_tpu_torch.config import glsl_expr
from glava_tpu_torch.config.glsl_expr import ExprError, tokenize
from glava_tpu_torch.ops import graph_while
from glava_tpu_torch.ops import latch as latch_ops
from glava_tpu_torch.ops import lookup as lookup_ops
from glava_tpu_torch.utils import profiling


class ShaderError(ValueError):
    """Shader parse/exec failure; carries the originating source
    location when known (``fname``/``line``), mapped back through the
    include tree like the reference's ss_lookup remap
    (glsl_ext.c:358-384, consumed at render.c:374-399)."""

    def __init__(self, msg: str, fname: str | None = None,
                 line: int | None = None):
        self.fname = fname
        self.line = line
        if fname is not None and line:
            msg = f"{fname}:{line}: {msg}"
        super().__init__(msg)


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class Decl:
    # (name, init token list or None, array-size token list or None)
    names: list[tuple[str, list | None, list | None]]
    line: int = 0
    # declared type name — consulted for default-init of struct-typed
    # declarations (`Ray r;` zero-fills per field); None for the
    # builtin types whose default-init has always been scalar 0.0
    dtype: str | None = None


@dataclass
class Assign:
    target: str
    swizzle: str | None
    op: str               # '=', '+=', '-=', '*=', '/='
    expr: list            # token list
    index: list | None = None  # a[i] = ... lvalue index tokens
    line: int = 0


@dataclass
class AssignPath:
    """Nested lvalue chain: ``name(.member | [idx])+ op expr`` with at
    least two path items (single-item forms use :class:`Assign`).
    Items are ("m", member-name) or ("i", index token list) — e.g.
    ``ray.dir.x = v`` or ``pts[i].pos = v`` (struct fields, vector
    components, array elements, in any nesting order)."""

    target: str
    items: list
    op: str               # '=', '+=', '-=', '*=', '/='
    expr: list
    line: int = 0


@dataclass
class If:
    cond: list
    then: list
    other: list = field(default_factory=list)
    line: int = 0


@dataclass
class Return:
    expr: list | None = None   # value returns allowed in helper functions
    line: int = 0


@dataclass
class ExprStmt:
    expr: list
    line: int = 0


@dataclass
class ForLoop:
    """Counted loop: unrolled when the bounds are compile-time
    constants, lowered to a masked while loop otherwise."""

    var: str
    start: list          # init expression tokens
    cond_op: str         # '<', '<=', '>' or '>='
    bound: list          # bound expression tokens
    step: list | None    # step MAGNITUDE tokens (None = 1)
    body: list
    line: int = 0
    step_sign: int = 1   # -1 for decrementing loops (i--, i -= k)


@dataclass
class WhileLoop:
    """Data-dependent loop: per-pixel masked iteration lowered to
    an eager masked loop (pixels retire as their condition goes false or
    they `break`; the loop exits when every pixel has retired).

    ``epilogue`` statements run after each iteration's body with
    `continue`d pixels re-activated — the landing point of `continue`.
    Dynamic-`for` lowers its increment there (a `continue` must still
    advance the counter) and `do`-`while` lowers its condition check
    there (GLSL `continue` jumps to the condition)."""

    cond: list
    body: list
    epilogue: list = field(default_factory=list)
    line: int = 0


@dataclass
class Switch:
    """GLSL `switch` with C fallthrough: each case group is a
    (label-token-lists | None-for-default, body) pair in source
    order."""

    expr: list
    cases: list
    line: int = 0


@dataclass
class Break:
    line: int = 0


@dataclass
class Continue:
    line: int = 0


_TYPES = ("float", "int", "bool", "uint", "vec2", "vec3", "vec4",
          "ivec2", "ivec3", "ivec4", "bvec2", "bvec3", "bvec4",
          "uvec2", "uvec3", "uvec4",
          "mat2", "mat3", "mat4", "highp", "lowp",
          "mediump", "const")


class _StmtParser:
    """Token-stream statement parser for main()'s body."""

    def __init__(self, toks: list[tuple[str, str]],
                 lines: list[int] | None = None,
                 struct_types: frozenset = frozenset()):
        self.toks = toks
        self.lines = lines
        self.pos = 0
        self.struct_types = struct_types

    def _is_type(self, v: str) -> bool:
        return v in _TYPES or v in self.struct_types

    def cur_line(self) -> int:
        if not self.lines:
            return 0
        return self.lines[min(self.pos, len(self.lines) - 1)]

    def peek(self):
        return self.toks[self.pos]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, val):
        k, v = self.next()
        if v != val:
            raise ShaderError(f"expected {val!r}, got {v!r}")

    def at_end(self):
        return self.peek()[0] == "end"

    def parse_block(self) -> list:
        self.expect("{")
        out = []
        while self.peek()[1] != "}":
            if self.at_end():
                raise ShaderError("unterminated block")
            out.append(self.parse_stmt())
        self.next()
        return out

    def collect_expr(self, stops=(";",)) -> list:
        """Grab raw tokens (balanced parens/brackets) until a stop."""
        depth = 0
        bdepth = 0
        toks = []
        while True:
            k, v = self.peek()
            if k == "end":
                raise ShaderError("unterminated expression")
            if depth == 0 and bdepth == 0 and v in stops:
                break
            if v == "(":
                depth += 1
            elif v == ")":
                if depth == 0:
                    break
                depth -= 1
            elif v == "[":
                bdepth += 1
            elif v == "]":
                if bdepth == 0:
                    break
                bdepth -= 1
            toks.append(self.next())
        return toks + [("end", "")]

    def parse_stmt(self):
        ln = self.cur_line()
        stmt = self._parse_stmt_inner()
        if ln and getattr(stmt, "line", 1) == 0:
            stmt.line = ln
        return stmt

    def _parse_stmt_inner(self):
        k, v = self.peek()
        if v == "{":
            return If([("ident", "true"), ("end", "")], self.parse_block())
        if v == "if":
            self.next()
            self.expect("(")
            cond = self.collect_expr(stops=(")",))
            self.expect(")")
            then = (self.parse_block() if self.peek()[1] == "{"
                    else [self.parse_stmt()])
            other = []
            if self.peek()[1] == "else":
                self.next()
                other = (self.parse_block() if self.peek()[1] == "{"
                         else [self.parse_stmt()])
            return If(cond, then, other)
        if v == "return":
            self.next()
            if self.peek()[1] != ";":
                expr = self.collect_expr(stops=(";",))
                self.expect(";")
                return Return(expr=expr)
            self.expect(";")
            return Return()
        if v == "discard":
            self.next()
            self.expect(";")
            # discard = emit nothing for this pixel and retire it
            return If([("ident", "true"), ("end", "")],
                      [Assign("fragment", None, "=",
                              tokenize("vec4(0, 0, 0, 0)")), Return()])
        if v == "for":
            return self._parse_for()
        if v == "switch":
            self.next()
            self.expect("(")
            selexpr = self.collect_expr(stops=(")",))
            self.expect(")")
            self.expect("{")
            cases: list = []
            while self.peek()[1] != "}":
                if self.at_end():
                    raise ShaderError("unterminated switch")
                t = self.peek()[1]
                if t == "case":
                    self.next()
                    lab = self.collect_expr(stops=(":",))
                    self.expect(":")
                    cases.append(([lab], []))
                elif t == "default":
                    self.next()
                    self.expect(":")
                    cases.append((None, []))
                else:
                    if not cases:
                        raise ShaderError(
                            "switch statement before the first case label")
                    cases[-1][1].append(self.parse_stmt())
            self.next()
            return Switch(selexpr, cases)
        if v == "while":
            self.next()
            self.expect("(")
            cond = self.collect_expr(stops=(")",))
            self.expect(")")
            body = (self.parse_block() if self.peek()[1] == "{"
                    else [self.parse_stmt()])
            return WhileLoop(cond, body)
        if v == "break":
            self.next()
            self.expect(";")
            return Break()
        if v == "continue":
            self.next()
            self.expect(";")
            return Continue()
        if v == "do":
            # do { body } while (cond);
            #   ==  while (true) { body; if (!(cond)) break; }
            self.next()
            body = (self.parse_block() if self.peek()[1] == "{"
                    else [self.parse_stmt()])
            self.expect("while")
            self.expect("(")
            cond = self.collect_expr(stops=(")",))
            self.expect(")")
            self.expect(";")
            neg = ([("op", "!"), ("op", "(")] + cond[:-1]
                   + [("op", ")"), ("end", "")])
            # the condition check lives in the epilogue: GLSL `continue`
            # inside a do-while jumps to the condition, not past it
            return WhileLoop([("ident", "true"), ("end", "")],
                             body, epilogue=[If(neg, [Break()])])
        if self._is_type(v):
            # declaration: type [precision] name[size?] [= expr] {, ...}
            dtype = None
            while self._is_type(self.peek()[1]):
                t = self.next()[1]
                if dtype is None and t not in ("highp", "lowp",
                                               "mediump", "const"):
                    dtype = t
            names = []
            while True:
                kk, name = self.next()
                if kk != "ident":
                    raise ShaderError(f"expected identifier, got {name!r}")
                arrsize = None
                if self.peek()[1] == "[":
                    self.next()
                    arrsize = (self.collect_expr(stops=("]",))
                               if self.peek()[1] != "]" else [("end", "")])
                    self.expect("]")
                init = None
                if self.peek()[1] == "=":
                    self.next()
                    init = self.collect_expr(stops=(";", ","))
                names.append((name, init, arrsize))
                if self.peek()[1] == ",":
                    self.next()
                    continue
                break
            self.expect(";")
            return Decl(names, dtype=dtype)
        # assignment or expression statement
        save = self.pos
        if k == "ident":
            name = self.next()[1]
            # collect a full lvalue path (`[idx]` / `.member` items);
            # if no assignment operator follows, backtrack — it was an
            # expression like `a.x + b` or a call statement
            items: list = []
            while True:
                nxt = self.peek()[1]
                if nxt == "[":
                    self.next()
                    items.append(("i", self.collect_expr(stops=("]",))))
                    self.expect("]")
                elif nxt == ".":
                    save2 = self.pos
                    self.next()
                    kk, mem = self.next()
                    if kk != "ident":
                        self.pos = save2
                        break
                    items.append(("m", mem))
                else:
                    break
            if self.peek()[1] in ("=", "+=", "-=", "*=", "/=", "%=", "<<=", ">>=", "&=", "|=", "^="):
                op = self.next()[1]
                expr = self.collect_expr(stops=(";",))
                self.expect(";")
                # single-item paths keep the legacy Assign shapes (all
                # downstream fast paths match on them); `a[i].f = x`
                # keeps the index+swizzle form it always had
                if not items:
                    return self._maybe_assign_expr(
                        Assign(name, None, op, expr))
                if len(items) == 1 and items[0][0] == "m":
                    return self._maybe_assign_expr(
                        Assign(name, items[0][1], op, expr))
                if len(items) == 1 and items[0][0] == "i":
                    return self._maybe_assign_expr(
                        Assign(name, None, op, expr, items[0][1]))
                if (len(items) == 2 and items[0][0] == "i"
                        and items[1][0] == "m"):
                    return self._maybe_assign_expr(
                        Assign(name, items[1][1], op, expr, items[0][1]))
                return AssignPath(name, items, op, expr)
            if self.peek()[1] in ("++", "--"):
                # postfix increment/decrement STATEMENT (value unused)
                aop = "+=" if self.next()[1] == "++" else "-="
                self.expect(";")
                one = [("num", "1.0"), ("end", "")]
                if not items:
                    return Assign(name, None, aop, one)
                if len(items) == 1 and items[0][0] == "m":
                    return Assign(name, items[0][1], aop, one)
                if len(items) == 1 and items[0][0] == "i":
                    return Assign(name, None, aop, one, items[0][1])
                return AssignPath(name, items, aop, one)
            self.pos = save
        if v in ("++", "--"):
            # prefix increment/decrement statement
            aop = "+=" if self.next()[1] == "++" else "-="
            kk, name = self.next()
            if kk != "ident":
                raise ShaderError(f"expected identifier after '{v}'")
            self.expect(";")
            return Assign(name, None, aop, [("num", "1.0"), ("end", "")])
        expr = self.collect_expr(stops=(";",))
        self.expect(";")
        inner = self._inner_assignment(expr)
        if inner is not None:
            return inner
        return ExprStmt(expr)

    @staticmethod
    def _whole_paren(t) -> bool:
        if not (t and t[0][1] == "(" and t[-1][1] == ")"):
            return False
        depth = 0
        for i, (_, v) in enumerate(t):
            if v == "(":
                depth += 1
            elif v == ")":
                depth -= 1
                if depth == 0 and i != len(t) - 1:
                    return False
        return True

    def _parse_for(self):
        """`for (TYPE i = a; i < b; i++/i += k) body` with bounds that
        resolve to constants through the macro environment — unrolled
        at execution."""
        self.next()  # 'for'
        self.expect("(")
        dtype = None
        while self._is_type(self.peek()[1]):
            t = self.next()[1]
            if dtype is None and t not in ("highp", "lowp",
                                           "mediump", "const"):
                dtype = t
        k, var = self.next()
        if k != "ident":
            raise ShaderError("for-loop needs a simple counter variable")
        self.expect("=")
        start = self.collect_expr(stops=(";", ","))
        # extra declarators in the init (`for (int i = 0, j = 2; ...`):
        # declared before the loop (GLSL scopes them to the loop; our
        # flat-scope superset is harmless)
        extra = []
        while self.peek()[1] == ",":
            self.next()
            kk, nm = self.next()
            if kk != "ident":
                raise ShaderError(
                    f"expected identifier in for-init, got {nm!r}")
            init = None
            if self.peek()[1] == "=":
                self.next()
                init = self.collect_expr(stops=(";", ","))
            extra.append((nm, init, None))
        self.expect(";")
        k, cv = self.next()
        if cv != var:
            raise ShaderError("for-loop condition must test the counter")
        op = self.next()[1]
        if op not in ("<", "<=", ">", ">="):
            raise ShaderError(f"unsupported for-loop comparison '{op}'")
        bound = self.collect_expr(stops=(";",))
        self.expect(";")
        # increment: i++ / ++i / i += k / i = i + k, and the
        # decrementing forms i-- / --i / i -= k / i = i - k
        step = None
        sign = 1
        inc = self.collect_expr(stops=(")",))
        inc_t = [x for x in inc if x[0] != "end"]
        vals = [x[1] for x in inc_t]
        if vals in ([var, "++"], ["++", var]):
            step = None
        elif vals in ([var, "--"], ["--", var]):
            step, sign = None, -1
        elif len(inc_t) >= 3 and vals[0] == var and vals[1] in ("+=", "-="):
            step = inc_t[2:] + [("end", "")]
            sign = 1 if vals[1] == "+=" else -1
        elif len(inc_t) >= 5 and vals[:4] in ([var, "=", var, "+"],
                                              [var, "=", var, "-"]):
            step = inc_t[4:] + [("end", "")]
            sign = 1 if vals[3] == "+" else -1
        else:
            raise ShaderError(
                f"unsupported for-loop increment {' '.join(vals)!r}"
            )
        self.expect(")")
        body = (self.parse_block() if self.peek()[1] == "{"
                else [self.parse_stmt()])
        loop = ForLoop(var, start, op, bound, step, body,
                       step_sign=sign)
        if extra:
            # GLSL initializes declarators left-to-right: the counter
            # first (extras may reference it), then the extras; the
            # loop itself re-evaluates `start` (init expressions are
            # side-effect-free in this subset). The literal-true If is
            # the block idiom — the executor runs it under the
            # UNCHANGED mask.
            return If([("ident", "true"), ("end", "")],
                      [Decl([(var, start, None)], dtype=dtype),
                       Decl(extra, dtype=dtype), loop])
        return loop

    def _inner_assignment(self, toks):
        """`( [(]ident[)] [.swz] = expr )` as a statement — the
        expansion shapes of the reference's APPLY_FRAG(f, c) macro
        (radial/1.frag:35, args are paren-wrapped on expansion)."""
        t = [x for x in toks if x[0] != "end"]
        while self._whole_paren(t):
            inner = t[1:-1]
            # collapse parens around a bare lvalue: `( ident ) = ...`
            if len(inner) >= 3 and inner[0][1] == "(" \
                    and inner[1][0] == "ident" and inner[2][1] == ")":
                inner = [inner[1]] + inner[3:]
            if inner and inner[0][0] == "ident":
                if len(inner) > 1 and inner[1][1] == "=":
                    return Assign(inner[0][1], None, "=",
                                  inner[2:] + [("end", "")])
                if len(inner) > 3 and inner[1][1] == "." \
                        and inner[2][0] == "ident" and inner[3][1] == "=":
                    return Assign(inner[0][1], inner[2][1], "=",
                                  inner[4:] + [("end", "")])
            t = inner
        return None

    def _maybe_assign_expr(self, a: Assign):
        """`x = (y = expr);` -> `y = expr; x = y;`"""
        inner = self._inner_assignment(a.expr)
        if inner is not None and a.op == "=":
            return If([("ident", "true"), ("end", "")],
                      [inner,
                       Assign(a.target, a.swizzle, "=",
                              [("ident", inner.target), ("end", "")],
                              a.index)])
        return a


# ---------------------------------------------------------------------------
# source-level parsing: requests, uniforms, main body
# ---------------------------------------------------------------------------

_REQ_UNIFORM = re.compile(r'^\s*#request\s+uniform\s+"(\w+)"\s+(\w+)\s*$',
                          re.M)
_REQ_TRANSFORM = re.compile(r'^\s*#request\s+transform\s+(\w+)\s+"(\w+)"\s*$',
                            re.M)
_PIXEL_CENTER = re.compile(r"layout\s*\(\s*pixel_center_integer\s*\)")


@dataclass
class FuncDef:
    """A helper function (statements + optional tail value return)."""

    name: str
    params: list[str]
    body: list
    # declared return type — used to build a typed zero when a valued
    # `return` inside a data-dependent loop must ride the loop carry
    rettype: str = "void"
    # per-param qualifiers ('', 'in', 'out', 'inout'): out/inout params
    # copy their final value back to the caller's argument lvalue
    quals: tuple = ()


@dataclass
class ParsedShader:
    uniforms: list[tuple[str, str]]            # (source, uniform name)
    transforms: dict[str, list[str]]           # uniform name -> chain
    body: list                                  # main() statement AST
    pixel_center_integer: bool
    funcs: dict[str, FuncDef] = field(default_factory=dict)
    pre_body: list = field(default_factory=list)  # file-scope declarations
    # user `struct` declarations: name -> [(field type, field name), ...]
    structs: dict[str, list] = field(default_factory=dict)
    # error-location support: the pass file name and the preprocessor's
    # per-line source map (PREPROCESSED line -> (origin file, line))
    fname: str = "<shader>"
    srcmap: list | None = None


_FUNC_TYPES = ("float|int|bool|uint|void|vec2|vec3|vec4"
               "|ivec2|ivec3|ivec4|bvec2|bvec3|bvec4|uvec2|uvec3|uvec4"
               "|highp|lowp|mediump")
_FUNC_DEF = re.compile(
    rf"\b({_FUNC_TYPES})\s+(\w+)\s*\(([^)]*)\)\s*\{{"
)


def _func_def_re(struct_names) -> "re.Pattern":
    """The helper-definition matcher, extended with user struct names
    so struct-returning helpers are extracted too."""
    if not struct_names:
        return _FUNC_DEF
    alts = "|".join(re.escape(n) for n in sorted(struct_names))
    return re.compile(
        rf"\b({_FUNC_TYPES}|{alts})\s+(\w+)\s*\(([^)]*)\)\s*\{{")


_STRUCT_DEF = re.compile(r"\bstruct\s+(\w+)\s*\{([^}]*)\}\s*(\w+)?\s*;")


def extract_structs(text: str) -> tuple[dict[str, list], str, list]:
    """Pull `struct Name { type field; ... } [var];` declarations out of
    the source. Returns (structs, text-with-spans-blanked, trailing
    variable declarations as (typename, varname) pairs). Removed spans
    become newlines so line numbering survives for error source maps.
    Nested braces inside struct bodies are not GLSL, so the regex's
    flat-body assumption is safe."""
    structs: dict[str, list] = {}
    trailing: list[tuple[str, str]] = []
    out = []
    i = 0
    while True:
        m = _STRUCT_DEF.search(text, i)
        if not m:
            out.append(text[i:])
            break
        out.append(text[i:m.start()])
        name = m.group(1)
        fields: list[tuple[str, str]] = []
        for part in m.group(2).split(";"):
            part = part.strip()
            if not part:
                continue
            toks = part.split()
            if len(toks) < 2:
                raise ShaderError(
                    f"struct {name}: cannot parse field '{part}'")
            ftype = next((t for t in toks[:-1]
                          if t not in ("highp", "lowp", "mediump")),
                         toks[0])
            # `type a, b` field lists
            for fn_ in " ".join(toks[1:]).split(","):
                fn_ = fn_.strip()
                if fn_:
                    fields.append((ftype, fn_))
        if not fields:
            raise ShaderError(f"struct {name} has no fields")
        structs[name] = fields
        if m.group(3):
            trailing.append((name, m.group(3)))
        out.append("\n" * text.count("\n", m.start(), m.end()))
        i = m.end()
    return structs, "".join(out), trailing

# helpers provided as interpreter builtins: their GLSL definitions
# (from inlined utility includes) are discarded
_BUILTIN_NAMES = {"smooth_audio", "smooth_audio_adj", "scale_audio",
                  "iscale_audio"}


def _param_names(sig: str) -> list[str]:
    names = []
    for part in sig.split(","):
        toks = part.strip().split()
        if toks:
            names.append(toks[-1])
    return names


def _param_quals(sig: str) -> tuple:
    """Per-param in/out/inout qualifiers ('' when unqualified)."""
    quals = []
    for part in sig.split(","):
        toks = part.strip().split()
        if toks:
            quals.append(next((t for t in toks[:-1]
                               if t in ("in", "out", "inout")), ""))
    return tuple(quals)


def extract_functions(text: str, struct_types: frozenset = frozenset()
                      ) -> tuple[dict[str, FuncDef], str]:
    """Pull helper-function definitions out of the source (parsed into
    executable FuncDefs unless they shadow interpreter builtins).
    Removed spans are replaced by equivalent newlines so the remaining
    text keeps its original line numbering (error source maps)."""
    from glava_tpu_torch.config.glsl_expr import tokenize_lines

    fdef_re = _func_def_re(struct_types)
    funcs: dict[str, FuncDef] = {}
    out = []
    i = 0
    while True:
        m = fdef_re.search(text, i)
        if not m:
            out.append(text[i:])
            break
        if m.group(2) == "main":
            out.append(text[i:m.end()])
            i = m.end()
            continue
        out.append(text[i:m.start()])
        depth = 1
        j = m.end()
        while j < len(text) and depth:
            if text[j] == "{":
                depth += 1
            elif text[j] == "}":
                depth -= 1
            j += 1
        name = m.group(2)
        if name not in _BUILTIN_NAMES:
            body_text = "{" + text[m.end():j]
            # "{" is prepended without a newline, so relative line 1
            # of body_text is the line of m.end() in the full text
            base = text.count("\n", 0, m.end())
            toks, lns = tokenize_lines(body_text, base=base)
            p = _StmtParser(toks, lns, struct_types)
            try:
                body = p.parse_block()
            except ShaderError as e:
                if e.fname is None and not e.line:
                    # carry the line; the caller resolves the file
                    raise ShaderError(str(e), None,
                                      p.cur_line()) from None
                raise
            rettype = m.group(1)
            if rettype in ("highp", "lowp", "mediump"):
                rettype = "float"
            funcs[name] = FuncDef(name, _param_names(m.group(3)), body,
                                  rettype=rettype,
                                  quals=_param_quals(m.group(3)))
        out.append("\n" * text.count("\n", m.start(), j))
        i = j
    return funcs, "".join(out)


def _strip_directives(text: str) -> str:
    """Remove remaining preprocessor lines and declarations the
    interpreter handles out-of-band (uniform/in/out declarations)."""
    out = []
    for line in text.split("\n"):
        s = line.strip()
        if s.startswith("#") or re.match(
                r"^(layout\s*\(.*\)\s*)?(in|out|uniform)\s+", s) \
                or re.match(r"^precision\s+(highp|mediump|lowp)\s+", s):
            out.append("")  # keep line numbering intact for srcmaps
            continue
        out.append(line)
    return "\n".join(out)


def parse_declarations(text: str) -> ParsedShader:
    """Uniform/transform/pci declarations only (no body parse) — used
    at registration time so syntax errors surface at module build."""
    uniforms = [(src, name) for src, name in _REQ_UNIFORM.findall(text)]
    transforms: dict[str, list[str]] = {}
    for name, tr in _REQ_TRANSFORM.findall(text):
        transforms.setdefault(name, []).append(tr)
    pci = bool(_PIXEL_CENTER.search(text))
    return ParsedShader(uniforms, transforms, [], pci)


def parse_shader(text: str, fname: str = "<shader>",
                 srcmap: list | None = None) -> ParsedShader:
    from glava_tpu_torch.config.glsl_expr import tokenize_lines

    structs, text, struct_vars = extract_structs(text)
    stypes = frozenset(structs)

    def located_block(toks, lns):
        p = _StmtParser(toks, lns, stypes)
        try:
            return p.parse_block()
        except ShaderError as e:
            if e.fname is not None:
                raise
            f, ln = _resolve_srcline(fname, srcmap, p.cur_line())
            raise ShaderError(str(e), f, ln) from None

    decls = parse_declarations(text)
    uniforms, transforms, pci = decls.uniforms, decls.transforms, \
        decls.pixel_center_integer

    try:
        funcs, ftext = extract_functions(text, stypes)
    except ShaderError as e:
        if e.fname is None and e.line:
            f, ln = _resolve_srcline(fname, srcmap, e.line)
            raise ShaderError(str(e), f, ln) from None
        raise
    m = re.search(r"void\s+main\s*\(\s*\)\s*", ftext)
    if not m:
        raise ShaderError("no `void main()` found", fname, 1)
    # file-scope declarations before main() (e.g. graph/1.frag:83-85);
    # no strip: blank prefixes keep line numbers aligned with the file
    pre_text = _strip_directives(ftext[: m.start()])
    pre_body = []
    if pre_text.strip():
        toks, lns = tokenize_lines("{" + pre_text + "}")
        pre_body = located_block(toks, lns)
    rest = _strip_directives(ftext[m.end():])
    base = ftext.count("\n", 0, m.end())
    toks, lns = tokenize_lines(rest, base=base)
    body = located_block(toks, lns)
    # `struct Foo {...} bar;` also declares a file-scope variable
    for tname, vname in struct_vars:
        pre_body.insert(0, Decl([(vname, None, None)], dtype=tname))
    return ParsedShader(uniforms, transforms, body, pci, funcs, pre_body,
                        structs=structs, fname=fname, srcmap=srcmap)


def _resolve_srcline(fname: str, srcmap: list | None, ln: int):
    """Map a PREPROCESSED line back to (origin file, origin line)."""
    if srcmap and 1 <= ln <= len(srcmap):
        return srcmap[ln - 1]
    return fname, ln



# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _is_t(x) -> bool:
    return isinstance(x, torch.Tensor)


def _np_concrete(*xs) -> bool:
    """True when every value is host-concrete (numpy or python scalar):
    a select over such values stays NUMPY, so coordinate planes keep
    their inspectable structure for the fetch routes."""
    return all(isinstance(x, (np.ndarray, np.generic, bool, int, float))
               for x in xs)


def _bool_t(x, device) -> torch.Tensor:
    return glsl_expr._tensor(x, device).to(torch.bool)


def _band(a, b):
    """Elementwise AND of masks, numpy-preserving (numpy and torch do
    not mix under python operators)."""
    if _np_concrete(a, b):
        return np.logical_and(a, b)
    dev = glsl_expr._device_of(a, b)
    return _bool_t(a, dev) & _bool_t(b, dev)


def _bor(a, b):
    if _np_concrete(a, b):
        return np.logical_or(a, b)
    dev = glsl_expr._device_of(a, b)
    return _bool_t(a, dev) | _bool_t(b, dev)


def _bnot(a):
    if _np_concrete(a):
        return np.logical_not(a)
    return ~a.to(torch.bool)


def _where(mask, n, o):
    """``where(mask, n, o)``: numpy when every operand is host-concrete,
    else torch on the device of the tensor operands."""
    if _np_concrete(mask, n, o):
        return np.where(mask, n, o)
    return glsl_expr._tnp().where(mask, n, o)


class _Exec:
    """Vectorized executor: every variable is a scalar/bool/array or a
    component tuple broadcastable over the (H, W) grid; control flow is
    carried as an active-pixel mask."""

    def __init__(self, env: glsl_expr.Env, h: int, w: int, device="cpu"):
        self.env = env
        self.h, self.w = h, w
        self.device = torch.device(device)
        self.mask = torch.ones((h, w), dtype=torch.bool, device=self.device)
        # identity-tracked pristine mask: assignments under it skip the
        # where-merge entirely (where(True, new, old) == new), so
        # top-level writes like `half_w = screen.x / 2` keep CONCRETE
        # numpy values instead of becoming device planes — every fetch
        # route that inspects coordinate math relies on it
        self._full_mask = self.mask
        self._frames: list[dict] = []  # function scopes: name -> (had, old)
        self._fn_stack: list[dict] = []  # per-call return bookkeeping
        self._loop_stack: list[dict] = []  # break/continue bookkeeping
        # `return` inside a data-dependent loop must retire pixels
        # BEYOND the loop: each _while_loop iteration pushes
        # {"mask", "fn_depth"} here and folds the plane into its state
        self._ret_stack: list[dict] = []
        self._user_funcs: dict[str, FuncDef] = {}
        self._structs: dict[str, list] = {}
        # fetch provenance: planes whose texel fetch can be resolved
        # structurally (first-hit walk results and their masked
        # merges) — see texelFetch's _prov_resolved_prev route
        self._prov: list[tuple] = []
        global _CURRENT_EXEC
        _CURRENT_EXEC = self

    def _t(self, x) -> torch.Tensor:
        """Value -> tensor on this pass's device (numpy float64/int64
        narrowed to 32 bits)."""
        return glsl_expr._tensor(x, self.device)

    def _prov_lookup(self, v):
        for obj, node in reversed(self._prov):
            if v is obj:
                return node
        return None

    def _prov_merge(self, out, mask, new, old):
        """Record out == where(mask, new, old) when either side has
        known fetch provenance (so texel(out) resolves structurally)."""
        if (self._prov_lookup(new) is not None
                or self._prov_lookup(old) is not None):
            self._prov.append(
                (out, {"kind": "merge", "mask": mask,
                       "new": new, "old": old}))

    def call_function(self, fdef: FuncDef, args, out_sink: dict | None = None,
                      capture: tuple = ()) -> Any:
        """Execute a helper function inline under the current pixel mask.

        GLSL scoping: params/locals shadow and are restored afterwards;
        writes to outer names (e.g. `fragment`) persist. `return`
        (anywhere, with or without a value) retires pixels for the
        remainder of the call; per-pixel return values merge across
        return sites. The caller's mask is restored on exit."""
        env = self.env
        frame: dict = {}
        self._frames.append(frame)
        self._fn_stack.append({"value": None, "rettype": fdef.rettype})
        entry_mask = self.mask
        try:
            for p, a in zip(fdef.params, args):
                if p not in frame:
                    frame[p] = (p in env.variables, env.variables.get(p))
                env.variables[p] = a
            self.run(fdef.body)
            if out_sink is not None:
                for p in capture:
                    out_sink[p] = env.variables.get(p)
            return self._fn_stack[-1]["value"]
        finally:
            self._fn_stack.pop()
            self.mask = entry_mask
            frame = self._frames.pop()
            for name, (had, old) in frame.items():
                if had:
                    env.variables[name] = old
                else:
                    env.variables.pop(name, None)

    def bind_functions(self, funcs: dict) -> None:
        self._user_funcs = dict(funcs)
        for fname, fdef in funcs.items():
            outs = tuple(i for i, q in enumerate(fdef.quals or ())
                         if q in ("out", "inout"))
            if outs:
                wrapper = (lambda *a, _lvalues=None, f=fdef, o=outs:
                           self._call_with_outparams(f, a, o, _lvalues))
                # the expression parser sees this marker and supplies
                # each out-argument's lvalue token slice
                wrapper._needs_lvalues = outs
                self.env.functions[fname] = wrapper
            else:
                self.env.functions[fname] = (
                    lambda *a, f=fdef: self.call_function(f, a)
                )

    def _call_with_outparams(self, fdef: FuncDef, args, outs, lvalues):
        """Call a helper with out/inout params: after the body runs,
        each out param's final value is written back to the caller's
        argument lvalue (GLSL copy-out semantics), merged under the
        call-site pixel mask."""
        sink: dict = {}
        names = [fdef.params[i] for i in outs if i < len(fdef.params)]
        ret = self.call_function(fdef, args, out_sink=sink,
                                 capture=tuple(names))
        for i in outs:
            if i >= len(fdef.params):
                continue
            toks = (lvalues or {}).get(i)
            path = _lvalue_path(toks) if toks is not None else None
            if path is None:
                raise ShaderError(
                    f"argument {i + 1} of '{fdef.name}' is declared "
                    f"'{(fdef.quals or ())[i]}' and must be a variable "
                    "(or member/index chain), got an expression")
            name, items = path
            val = sink.get(fdef.params[i])
            if items:
                chain, _leaf = self._resolve_lvalue(name, items)
                val = self._rebuild_lvalue(chain, val)
            self._masked_set(name, val)
        return ret

    def bind_structs(self, structs: dict) -> None:
        """Register user struct types: `Name(...)` constructors become
        callables and `Name v;` declarations zero-fill per field."""
        self._structs = dict(structs)
        for sname, fields in structs.items():
            fnames = tuple(fn for _, fn in fields)

            def ctor(*args, sname=sname, fnames=fnames, fields=fields):
                if len(args) != len(fnames):
                    raise ShaderError(
                        f"struct {sname} constructor takes "
                        f"{len(fnames)} arguments, got {len(args)}")
                return glsl_expr.GlslStruct(sname, fnames, args)

            self.env.functions[sname] = ctor

    def _zero_struct(self, tname: str):
        """Default-init value for a struct-typed declaration."""
        fields = self._structs[tname]
        vals = []
        for ftype, _ in fields:
            if ftype in self._structs:
                vals.append(self._zero_struct(ftype))
            elif ftype in ("vec2", "vec3", "vec4"):
                vals.append((0.0,) * int(ftype[-1]))
            elif ftype in ("mat2", "mat3", "mat4"):
                n = int(ftype[-1])
                vals.append(glsl_expr.GlslMat(
                    tuple((0.0,) * n for _ in range(n))))
            elif ftype == "bool":
                vals.append(False)
            else:
                vals.append(0.0)
        return glsl_expr.GlslStruct(
            tname, tuple(fn for _, fn in fields), vals)

    def _eval(self, toks) -> Any:
        return glsl_expr._Parser(list(toks), self.env).parse()

    def _masked_set(self, name: str, value):
        old = self.env.variables.get(name)
        mask = self.mask
        if old is None or mask is None or (isinstance(mask, bool) and mask) \
                or mask is self._full_mask:
            self.env.variables[name] = value
            return

        def sel(n, o):
            # concrete operands under a concrete mask stay NUMPY (a
            # circle-style `if (dir > PI) idx = ...` would otherwise
            # turn the polar index planes into device planes)
            out = _where(mask, n, o)
            self._prov_merge(out, mask, n, o)
            return out

        def merge(value, old):
            if isinstance(value, glsl_expr.GlslStruct) \
                    or isinstance(old, glsl_expr.GlslStruct):
                if not (isinstance(value, glsl_expr.GlslStruct)
                        and isinstance(old, glsl_expr.GlslStruct)
                        and value.typename == old.typename):
                    raise ShaderError(
                        f"assignment changes struct type of '{name}'")
                return glsl_expr.GlslStruct(
                    value.typename, value.names,
                    [merge(a, b) for a, b in zip(value.vals, old.vals)])
            if isinstance(value, glsl_expr.GlslMat) \
                    or isinstance(old, glsl_expr.GlslMat):
                if not (isinstance(value, glsl_expr.GlslMat)
                        and isinstance(old, glsl_expr.GlslMat)
                        and value.n == old.n):
                    raise ShaderError(
                        f"assignment changes matrix shape of '{name}'")
                return glsl_expr.GlslMat(tuple(
                    tuple(sel(a, b) for a, b in zip(ca, cb))
                    for ca, cb in zip(value.cols, old.cols)))
            if isinstance(value, glsl_expr.GlslArray) \
                    or isinstance(old, glsl_expr.GlslArray):
                if not (isinstance(value, glsl_expr.GlslArray)
                        and isinstance(old, glsl_expr.GlslArray)
                        and len(value) == len(old)):
                    raise ShaderError(
                        f"assignment changes array shape of '{name}'"
                    )
                return glsl_expr.GlslArray(
                    [merge(a, b) for a, b in zip(value.elems, old.elems)]
                )
            if isinstance(value, tuple) or isinstance(old, tuple):
                vt = value if isinstance(value, tuple) else (value,) * len(old)
                ot = old if isinstance(old, tuple) else (old,) * len(vt)
                if len(vt) != len(ot):
                    raise ShaderError(
                        f"assignment changes vector size of '{name}'"
                    )
                return tuple(sel(a, b) for a, b in zip(vt, ot))
            return sel(value, old)

        self.env.variables[name] = merge(value, old)

    def run(self, body: list) -> None:
        for stmt in body:
            self._stmt(stmt)

    # set by the pass builder (glsl_module) so exec-time errors cite
    # the originating file:line through the include tree
    src_info: tuple[str, list | None] = ("<shader>", None)

    def _stmt(self, stmt) -> None:
        try:
            self._stmt_exec(stmt)
        except compiled.Uncapturable as e:
            # a capture's refusal names the statement that met it
            ln = getattr(stmt, "line", 0)
            if ln and not getattr(e, "located", False):
                fname, sl = _resolve_srcline(self.src_info[0],
                                             self.src_info[1], ln)
                err = compiled.Uncapturable(f"{fname}:{sl}: {e}")
                err.located = True
                raise err from None
            raise
        except (ShaderError, ExprError) as e:
            ln = getattr(stmt, "line", 0)
            if ln and not (isinstance(e, ShaderError)
                           and e.fname is not None):
                fname, sl = _resolve_srcline(self.src_info[0],
                                             self.src_info[1], ln)
                raise ShaderError(str(e), fname, sl) from None
            raise

    def _plane_mask(self, cond):
        """A condition -> (H, W) bool plane, numpy-preserving."""
        if _np_concrete(cond):
            return np.broadcast_to(np.asarray(cond, bool), (self.h, self.w))
        return _bool_t(cond, self.device).expand(self.h, self.w)

    def _stmt_exec(self, stmt) -> None:
        if isinstance(stmt, Decl):
            for name, init, arrsize in stmt.names:
                if arrsize is not None:
                    val = self._decl_array(name, init, arrsize,
                                           stmt.dtype)
                elif init is not None:
                    val = self._eval(init)
                elif stmt.dtype in self._structs:
                    val = self._zero_struct(stmt.dtype)
                else:
                    val = 0.0
                if self._frames:  # function locals: save the shadowed value
                    frame = self._frames[-1]
                    if name not in frame:
                        frame[name] = (name in self.env.variables,
                                       self.env.variables.get(name))
                # declarations introduce the name unconditionally
                self.env.variables[name] = val
        elif isinstance(stmt, Assign):
            toks = [t for t in stmt.expr if t[0] != "end"]
            # chained assignment `a = b = expr` (assignment as an
            # expression, e.g. a macro expanding to `(f = c)`): execute
            # the inner assignment, then reuse its value
            if (stmt.op == "=" and not stmt.swizzle
                    and stmt.index is None and len(toks) >= 3
                    and toks[0][0] == "ident"
                    and toks[1] == ("op", "=")):
                self._stmt(Assign(target=toks[0][1], swizzle=None,
                                  op="=", expr=toks[2:] + [("end", "")],
                                  line=stmt.line))
                self._masked_set(stmt.target,
                                 self.env.variables.get(toks[0][1]))
                return
            rhs = self._eval(stmt.expr)
            cur = self.env.variables.get(stmt.target)
            idx = self._eval(stmt.index) if stmt.index is not None else None
            elem = glsl_expr.index_value(cur, idx) if idx is not None else cur
            if stmt.op != "=":
                if cur is None:
                    raise ShaderError(f"'{stmt.target}' used before assignment")
                base = (self._component(elem, stmt.swizzle)
                        if stmt.swizzle else elem)
                rhs = _bin(base, rhs, stmt.op[:-1])
            if stmt.swizzle:
                if isinstance(elem, glsl_expr.GlslStruct):
                    # struct field assignment: v.field [op]= expr
                    rhs = elem.replace(stmt.swizzle, rhs)
                    if idx is not None:
                        rhs = glsl_expr.index_store(cur, idx, rhs)
                    self._masked_set(stmt.target, rhs)
                    return
                if not isinstance(elem, tuple):
                    raise ShaderError(
                        f"cannot swizzle-assign non-vector '{stmt.target}'"
                    )
                idxs = [glsl_expr._SWIZZLE[c] for c in stmt.swizzle]
                comps = list(elem)
                rt = rhs if isinstance(rhs, tuple) else (rhs,) * len(idxs)
                if len(rt) != len(idxs):
                    raise ShaderError("swizzle assignment size mismatch")
                for i, r in zip(idxs, rt):
                    comps[i] = r
                rhs = tuple(comps)
            if idx is not None:
                rhs = glsl_expr.index_store(cur, idx, rhs)
            self._masked_set(stmt.target, rhs)
        elif isinstance(stmt, AssignPath):
            chain, leaf = self._resolve_lvalue(stmt.target, stmt.items)
            rhs = self._eval(stmt.expr)
            if stmt.op != "=":
                rhs = _bin(leaf, rhs, stmt.op[:-1])
            self._masked_set(stmt.target, self._rebuild_lvalue(chain, rhs))
        elif isinstance(stmt, If):
            cond = self._eval(stmt.cond)
            if _np_concrete(cond) and not stmt.other:
                cnp = np.asarray(cond, bool)
                if cnp.all():
                    # uniformly true, no else: run the body under the
                    # UNCHANGED mask (the `{ block }` idiom and knob-
                    # gated branches must keep a pristine mask pristine)
                    self.run(stmt.then)
                    return
                if not cnp.any():
                    # uniformly false, no else: untaken
                    return
            cond = self._plane_mask(cond)
            outer = self.mask
            # the pristine mask is all-true: outer & cond == cond, and
            # skipping the AND keeps numpy conds numpy
            pristine = outer is self._full_mask
            tmask = cond if pristine else _band(outer, cond)
            emask = _bnot(cond) if pristine else _band(outer, _bnot(cond))
            self.mask = tmask
            self.run(stmt.then)
            then_mask = self.mask  # pixels still active (not returned)
            self.mask = emask
            self.run(stmt.other)
            if then_mask is tmask and self.mask is emask:
                # no return/discard in either branch: then|else == outer
                # exactly; restoring the identity keeps PRISTINE masks
                # pristine across ifs
                self.mask = outer
            else:
                self.mask = _bor(then_mask, self.mask)
        elif isinstance(stmt, Return):
            if self._fn_stack:
                fr = self._fn_stack[-1]
                if stmt.expr is not None:
                    v = self._eval(stmt.expr)
                    prior = fr["value"]
                    fr["value"] = _merge_masked(self.mask, v, fr["value"])
                    if not isinstance(v, (tuple, glsl_expr.GlslArray)):
                        self._prov_merge(
                            fr["value"], self.mask, v,
                            0.0 if prior is None else prior)
            elif stmt.expr is not None:
                raise ShaderError("main() cannot return a value")
            # inside a data-dependent loop at the same function depth:
            # record the retirement so it escapes the loop (nested
            # loops chain it outward level by level)
            if (self._ret_stack
                    and self._ret_stack[-1]["fn_depth"]
                    == len(self._fn_stack)):
                rc = self._ret_stack[-1]
                rc["mask"] = _bor(rc["mask"], self.mask)
            self.mask = _band(self.mask, False)
        elif isinstance(stmt, ExprStmt):
            self._eval(stmt.expr)
        elif isinstance(stmt, ForLoop):
            self._for_loop(stmt)
        elif isinstance(stmt, WhileLoop):
            self._while_loop(stmt)
        elif isinstance(stmt, Break):
            if not self._loop_stack:
                raise ShaderError("`break` outside a loop")
            ctx = self._loop_stack[-1]
            ctx["broken"] = (self.mask if ctx["broken"] is None
                             else _bor(ctx["broken"], self.mask))
            self.mask = _band(self.mask, False)
        elif isinstance(stmt, Continue):
            # `continue` binds to the enclosing LOOP, skipping switch
            # contexts (C semantics; `break` binds to the nearest of
            # either)
            loops = [c for c in self._loop_stack if not c.get("switch")]
            if not loops:
                raise ShaderError("`continue` outside a loop")
            ctx = loops[-1]
            ctx["continued"] = (self.mask if ctx["continued"] is None
                                else _bor(ctx["continued"], self.mask))
            self.mask = _band(self.mask, False)
        elif isinstance(stmt, Switch):
            self._switch(stmt)
        else:  # pragma: no cover
            raise ShaderError(f"unknown statement {stmt!r}")

    def _switch(self, stmt: Switch) -> None:
        """GLSL switch with C fallthrough as masked case groups.

        The selector may be per-pixel; labels are constant expressions.
        Pixels enter at their matching label (default = matching NO
        label anywhere), flow into following groups until `break`
        retires them from the switch, and everything reactivates
        afterwards, except pixels retired by `return`. Numpy-preserving
        like `if`."""
        sel = self._eval(stmt.expr)
        outer = self.mask
        covered = None
        groups = []
        has_default = False
        for labels, body in stmt.cases:
            if labels is None:
                has_default = True
                groups.append((None, body))
                continue
            m = None
            for lt in labels:
                v = self._eval(lt)
                eq = glsl_expr._map2(lambda a, b: a == b,
                                     lambda a, b: a == b, sel, v)
                m = eq if m is None else _bor(m, eq)
            m = self._plane_mask(_band(m, outer))
            covered = m if covered is None else _bor(covered, m)
            groups.append((m, body))
        nobody = _band(outer, False)
        ctx = {"broken": None, "continued": None, "switch": True}
        self._loop_stack.append(ctx)
        self.mask = nobody
        try:
            for m, body in groups:
                if m is None:  # default: pixels matching no label
                    m = (nobody if covered is None
                         else _band(outer, _bnot(covered)))
                self.mask = _bor(self.mask, m)
                self.run(body)
        finally:
            self._loop_stack.pop()
        final = self.mask
        if ctx["broken"] is not None:
            final = _bor(final, ctx["broken"])
        if not has_default:
            # pixels matching nothing skip the switch but stay active
            final = _bor(final, outer if covered is None
                         else _band(outer, _bnot(covered)))
        self.mask = final

    _MAX_UNROLL = 4096

    def _for_loop(self, stmt: ForLoop) -> None:
        def concrete(toks, what):
            v = self._eval(toks)
            if _np_like_val(v):
                raise _DynamicBound(what)
            return float(v)

        env = self.env
        frame = self._frames[-1] if self._frames else None
        had = stmt.var in env.variables
        old = env.variables.get(stmt.var)
        try:
            # evaluate the init expression exactly ONCE (it may have
            # side effects); only the bound/step classification may
            # raise _DynamicBound
            start_v = self._eval(stmt.start)
            try:
                if _np_like_val(start_v):
                    raise _DynamicBound("start")
                i = float(start_v)
                bound = concrete(stmt.bound, "bound")
                step = (concrete(stmt.step, "step")
                        if stmt.step is not None else 1.0)
            except _DynamicBound:
                # data-dependent bounds: lower to a masked while loop
                # `for (i = a; i OP b; i += s)` ==
                # `i = a; while (i OP (b)) { body } /* epilogue: i += s */`
                # (the increment rides the epilogue so `continue` still
                # advances the counter)
                env.variables[stmt.var] = start_v
                cond = ([("ident", stmt.var), ("op", stmt.cond_op),
                         ("op", "(")] + [t for t in stmt.bound
                                         if t[0] != "end"]
                        + [("op", ")"), ("end", "")])
                inc = Assign(stmt.var, None,
                             "+=" if stmt.step_sign > 0 else "-=",
                             stmt.step if stmt.step is not None
                             else [("num", "1"), ("end", "")])
                self._while_loop(WhileLoop(cond, list(stmt.body),
                                           epilogue=[inc]))
                return
            if step <= 0:
                raise ShaderError(
                    "for-loop step magnitude must be positive")
            step *= stmt.step_sign
            cmp = {"<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
                   ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}[
                       stmt.cond_op]
            count = 0
            ctx = {"broken": None, "continued": None}
            self._loop_stack.append(ctx)
            try:
                while cmp(i, bound):
                    if count >= self._MAX_UNROLL:
                        raise ShaderError(
                            f"for-loop exceeds {self._MAX_UNROLL} iterations"
                        )
                    env.variables[stmt.var] = i
                    self.run(stmt.body)
                    if ctx["continued"] is not None:
                        self.mask = _bor(self.mask, ctx["continued"])
                        ctx["continued"] = None
                    i += step
                    count += 1
            finally:
                self._loop_stack.pop()
            if ctx["broken"] is not None:
                self.mask = _bor(self.mask, ctx["broken"])
        finally:
            if frame is None or stmt.var not in frame:
                if had:
                    env.variables[stmt.var] = old
                else:
                    env.variables.pop(stmt.var, None)

    def _cond_mask(self, toks):
        """Evaluate a loop/if condition to a (H, W) bool array
        (numpy-preserving for concrete conditions)."""
        return self._plane_mask(self._eval(toks))

    def _decl_array(self, name: str, init, arrsize, dtype=None):
        """`TYPE name[N];` / `TYPE name[] = TYPE[](...)` declaration."""
        size_toks = [t for t in arrsize if t[0] != "end"]
        n = None
        if size_toks:
            sv = self._eval(arrsize)
            if _np_like_val(sv):
                raise ShaderError(
                    f"array '{name}' size must be a compile-time constant"
                )
            n = int(sv)
        if init is None:
            if n is None:
                raise ShaderError(f"array '{name}' needs a size or initializer")
            if dtype in self._structs:   # struct arrays zero per element
                return glsl_expr.GlslArray(
                    [self._zero_struct(dtype) for _ in range(n)])
            return glsl_expr.GlslArray([0.0] * n)
        val = self._eval(init)
        if not isinstance(val, glsl_expr.GlslArray):
            raise ShaderError(
                f"array '{name}' initializer must be an array constructor "
                "like float[](a, b, c)"
            )
        if n is not None and len(val) != n:
            raise ShaderError(
                f"array '{name}' declares {n} elements, initializer has "
                f"{len(val)}"
            )
        return val

    _WHILE_FUEL_BASE = 4096

    # extra rows evaluated beyond the texture on each side in the
    # first-hit lowering; the out-of-texture (host numpy) part of the
    # domain additionally extends through the full fuel range in the
    # walk direction, so cond-exits anywhere before the fuel cap decode
    # exactly like the general lowering
    _WALK_SCAN_MARGIN = 64

    def _try_first_hit(self, stmt: WhileLoop, carried: list,
                       walk_info: dict, fuel_cap: int) -> bool:
        """Strength-reduce a first-hit walk loop to column scans.

        Applies when the loop is exactly the boundary-walk idiom
        (graph/3.frag get_col_height_up/_down):

            while (cond(y)) {            // y: sole carried variable,
                vec4 f = texelFetch(prev, ivec2(X, y), 0);
                if (pred(f)) { [y ±= c;] break; }
                y ±= d;                  // uniform-step walk variable
            }

        with X loop-invariant column-aligned, pred referencing only f
        (plus scalars / pure math builtins) and cond only y (same).
        Then the texel fetched at iteration i lives at extended row
        e = own_row + floor(c0) + d*i, so each pixel's exit iteration
        is "first e in direction d where !cond(e) or pred(texel[e])":
        ONE key scan over an extended texel plane (``latch_scan`` with
        C = 0) replaces the whole masked loop. The event key encodes
        2*row + type with cond-exit taking tie priority (the loop checks
        its condition before fetching); pixels with no event inside the
        extended domain retire as fuel-capped. Returns True when applied
        (loop effects fully committed)."""
        if len(carried) != 1 or carried[0] not in walk_info:
            return False
        yname = carried[0]
        k, d, frac = walk_info[yname]
        if abs(d) != 1:
            # the row scan assumes every row in the walk direction is
            # visited; |d| >= 2 walks skip rows — the walk-shift route
            # handles arbitrary integer steps exactly
            return False
        h, w = self.h, self.w
        M = self._WALK_SCAN_MARGIN
        if not 0 <= k <= h + M:
            return False
        body = stmt.body
        if len(body) != 3 or _contains_return(body):
            return False
        s0, s1, s2 = body
        if not (isinstance(s0, Decl) and len(s0.names) == 1
                and isinstance(s1, If) and not s1.other):
            return False
        fname, init, arrsz = s0.names[0]
        if arrsz is not None or init is None or fname == yname:
            return False
        args = _split_call(init, "texelFetch")
        if args is None or len(args) not in (2, 3):
            return False
        tex_t = [t for t in args[0] if t[0] != "end"]
        if (len(tex_t) != 1 or tex_t[0][0] != "ident"
                or self.env.variables.get(tex_t[0][1]) != "prev"):
            return False
        iargs = _split_call(args[1], "ivec2")
        if iargs is None or len(iargs) != 2:
            return False
        xtoks, ytoks = iargs
        if [t for t in ytoks if t[0] != "end"] != [("ident", yname)]:
            return False
        if not _idents_allowed(xtoks, lambda n: n not in (yname, fname)):
            return False
        then = s1.then
        adj = 0.0
        if len(then) == 1 and isinstance(then[0], Break):
            pass
        elif len(then) == 2 and isinstance(then[1], Break):
            adj_d = _walk_step_delta(then[0], yname)
            if adj_d is None:
                return False
            adj = adj_d
        else:
            return False
        env = self.env

        def lookup_scalar(n):
            try:
                return _scalar_like(env.lookup(n))
            except _EVAL_ERRORS:
                return False

        if not _idents_allowed(
                s1.cond, lambda n: n == fname or lookup_scalar(n)):
            return False
        if not _idents_allowed(
                stmt.cond, lambda n: n == yname or lookup_scalar(n)):
            return False
        ext_fn = env.functions.get("__ext_texels")
        if ext_fn is None:
            return False
        xval = self._eval(list(xtoks) + [("end", "")])
        if isinstance(xval, (tuple, glsl_expr.GlslArray)) or _is_t(xval):
            return False
        try:
            xn = np.asarray(xval, np.int32)
            np.broadcast_shapes(xn.shape, (h, w))
        except _EVAL_ERRORS:
            return False
        px = _col_pattern(xn, h, w)
        if px is None:
            return False

        lo, hi = -(h + M), 2 * h + M
        # extend the host-evaluated (out-of-texture) domain over the
        # FULL fuel range in the walk direction: a condition like
        # `y < BIG` can exit beyond 2h+M yet before the fuel cap.
        # Rows outside the texture read black, so the extension is all
        # host numpy (no extra device work).
        if d > 0:
            hi = max(hi, h + k + fuel_cap + 2)
        else:
            lo = min(lo, k - fuel_cap - 1)
        E = hi - lo
        if 2 * E >= (1 << 24):
            # keys must stay exact in float32; absurd fuel caps take
            # the general lowering instead
            return False
        # keys are exact small integers (2*ext_row + bit < 2^24) held in
        # float32; decode converts the final (h, w) plane to int32
        SENT = np.float32(1 << 30) if d > 0 else np.float32(-1)
        bit_cond, bit_hit = (0, 1) if d > 0 else (1, 0)

        def eval_with(name, value, toks):
            had, old = name in env.variables, env.variables.get(name)
            env.variables[name] = value
            try:
                return self._eval(toks)
            finally:
                if had:
                    env.variables[name] = old
                else:
                    env.variables.pop(name, None)

        # The scan runs ONCE per signature on the IDENTITY column
        # mapping, and the x pattern is applied to the RESULT
        # (first-event scans commute with column shifts): graph/3.frag's
        # two up-walks (x-1 and x+1) share one scan. cond depends only
        # on y, so the whole out-of-texture event structure is host
        # numpy; only the in-texture rows [-1, h) need a device scan.
        # The signature includes the VALUES of the scalar identifiers
        # the conditions reference (one helper called with different
        # limits makes different scans).
        def _freeze(v):
            if isinstance(v, tuple):
                return tuple(_freeze(c) for c in v)
            if isinstance(v, bool):
                return v
            return float(np.asarray(v))

        def scalar_vals(toks, skip):
            tl = [t for t in (toks or []) if t[0] != "end"]
            vals = []
            for i, (kk, v) in enumerate(tl):
                if kk != "ident" or v in skip:
                    continue
                if i > 0 and tl[i - 1] == ("op", "."):
                    continue
                if i + 1 < len(tl) and tl[i + 1] == ("op", "("):
                    continue
                try:
                    vals.append((v, _freeze(env.lookup(v))))
                except _EVAL_ERRORS:
                    pass
            return tuple(sorted(set(vals)))

        sig = (tuple(t for t in s1.cond if t[0] != "end"),
               tuple(t for t in stmt.cond if t[0] != "end"),
               d, k, round(frac, 9), fuel_cap,
               scalar_vals(s1.cond, {fname}),
               scalar_vals(stmt.cond, {yname}))
        cache = getattr(self, "_fh_cache", None)
        if cache is None:
            cache = self._fh_cache = {}
        dev = self.device
        if sig in cache:
            fkI, oob_first, latch_maker = cache[sig]
        else:
            # the host half depends only on the signature (and h, w),
            # so it is planned once per pass and reused every frame
            plan_key = ("first_hit", h, w) + sig
            plan = _plan_cache_get(plan_key)
            if plan is None:
                yext = (np.arange(lo, hi, dtype=np.float64)
                        + frac).astype(np.float32)[:, None]     # (E, 1)
                # exotic-but-allowed expressions may still fail to
                # evaluate over the extended domain (e.g. tuple-typed
                # comparisons): take the general lowering
                try:
                    condV = eval_with(yname, yext, stmt.cond)
                    pred0 = eval_with(fname, (np.float32(0.0),) * 4,
                                      s1.cond)
                except _EVAL_ERRORS:
                    return False
                if _is_t(condV) or _is_t(pred0):
                    return False
                cv = np.asarray(condV)
                condV = np.broadcast_to(
                    cv if cv.dtype == np.bool_ else cv != 0, (E, 1))
                pred0 = bool(np.asarray(pred0))
                je = np.arange(E, dtype=np.int64)[:, None]
                keyV = (2 * je + np.where(~condV, bit_cond, bit_hit)
                        ).astype(np.float32)

                def first_scan_np(ev):
                    kv = np.where(ev, keyV, SENT)
                    if d > 0:
                        return np.ascontiguousarray(
                            np.minimum.accumulate(kv[::-1])[::-1])
                    return np.maximum.accumulate(kv)

                erows = np.arange(lo, hi)[:, None]
                out_rows = (erows < -1) | (erows >= h)
                out_first = first_scan_np(out_rows & (~condV | pred0))
                oob_col_first = first_scan_np(~condV | pred0)
                inrows = slice(-1 - lo, h - lo)
                plan = (condV[inrows].copy(), keyV[inrows].copy(),
                        out_first, oob_col_first)
                _plan_cache_put(plan_key, plan)
            condIN, key_in, out_first, oob_col_first = plan
            sl = slice(k - lo, k - lo + h)
            oob_first = compiled.const(oob_col_first[sl], dev)

            ext = ext_fn(("shift", 0), frac > 0, -1, h)     # (h+1, w) x4
            if ext is None:
                return False
            try:
                predP = eval_with(fname, ext, s1.cond)
            except _EVAL_ERRORS:
                return False
            a = self._t(predP)
            if a.dtype != torch.bool:
                a = a != 0
            predB = a.expand(h + 1, w)
            cond_t = compiled.const(condIN, dev)      # (h+1, 1)
            event_in = ~cond_t | (cond_t & predB)
            kin = torch.where(event_in, compiled.const(key_in, dev),
                              float(SENT)).contiguous()
            in_scan = latch_ops.latch_scan(kin, (), d > 0, float(SENT))[0]
            # pixel row r starts at ext row e0 = r + k -> IN index
            # r + k + 1 in [k+1, h+k]; rows past the IN domain see no
            # further IN events walking up (SENT) but inherit ALL of
            # them walking down (the accumulated last row)
            if k:
                padrow = (torch.full((k, w), float(SENT), device=dev)
                          if d > 0 else in_scan[-1:].expand(k, w))
                in_scan = torch.cat([in_scan, padrow], dim=0)
            in_part = in_scan[k + 1:k + 1 + h]
            out_part = compiled.const(out_first[sl], dev)  # (h, 1)
            fkI = (torch.minimum if d > 0 else torch.maximum)(in_part,
                                                              out_part)
            latch_maker = self._make_latch_maker(
                kin=kin, ext=ext, condIN=condIN,
                out_np=out_first[sl][:, 0].copy(), fkI=fkI,
                d=d, k=k, frac=frac, adj=adj, SENT=SENT,
                bit_hit=bit_hit, fuel_cap=fuel_cap, lo=lo,
                plan_key=plan_key)
            # values made inside a loop iteration are only reused at
            # loop depth 0, as in the JAX package
            if not self._loop_stack:
                cache[sig] = (fkI, oob_first, latch_maker)

        # apply the x pattern to the RESULT plane; columns read from
        # outside the texture see black at every row, so their
        # first-event is the all-out-of-range column vector
        if px[0] == "const":
            c = px[1]
            if 0 <= c < w:  # every pixel reads column c's scan
                fk = fkI[:, c:c + 1].expand(h, w)
            else:
                fk = oob_first.expand(h, w)
        elif px[1] == 0:
            fk = fkI
        else:
            fk = _apply_axis(fkI, px, 1, w)
            if px[0] == "shift":
                cols = np.arange(w) + px[1]
                oobc = (cols < 0) | (cols >= w)
                if oobc.any():
                    fk = torch.where(compiled.const(oobc, dev)[None, :],
                                     oob_first, fk)

        no_event = fk == float(SENT)
        fki = fk.to(torch.int32)
        jstar = fki >> 1
        cond_evt = (fki & 1) == bit_cond
        j0 = compiled.const(
            (np.arange(h, dtype=np.int64) + (k - lo)).astype(np.int32),
            dev)[:, None]
        raw = (jstar - j0) * int(d)
        fuelled = no_event | (raw >= fuel_cap)
        i_eff = torch.where(fuelled, fuel_cap, raw)
        brk_evt = ~fuelled & ~cond_evt
        # the entry plane keeps its broadcastable shape ((h, 1) for a
        # row coordinate): no (h, w) host plane to build and upload
        y0 = np.asarray(env.variables[yname], np.float64).astype(np.float32)
        y0_t = compiled.const(y0, dev)
        yf = (y0_t + float(d) * i_eff.to(torch.float32)
              + float(adj) * brk_evt.to(torch.float32))
        committed = _where(self.mask, yf, y0_t)
        env.variables[yname] = committed
        # provenance: later fetches AT the walk result (the anti-alias
        # idiom's `texelFetch(tex, ivec2(x, h2))`) resolve through
        # masked merges to ONE cached fetch on the pristine plane
        self._prov.append((yf, {"kind": "walk", "plane": yf,
                                "sig": ("fh",) + sig,
                                # latched texels only cover fetches at
                                # the SAME column mapping as the walk
                                "latch": (None if self._loop_stack
                                          else latch_maker),
                                "latch_px": px}))
        self._prov_merge(committed, self.mask, yf, y0)
        _WALK_HITS[0] += 1
        _fuel_add(_band(fuelled, self.mask), fuel_cap)
        return True

    def _make_latch_maker(self, *, kin, ext, condIN, out_np, fkI, d, k,
                          frac, adj, SENT, bit_hit, fuel_cap, lo, plan_key):
        """Build the lazy texel resolver for a first-hit walk result.

        Returns ``latch(px_f) -> (r, g, b, a) planes or None``: the
        texture value the shader reads at ``ivec2(px_f(col),
        walk_result)`` (the anti-alias idiom, graph/3.frag:84), computed
        WITHOUT any gather. The latch scan (``ops.latch``, C = 4)
        carries each extended row's candidate texel (hit events
        pre-shifted by the break adjust, cond-exit rows unshifted, both
        riding ext's int(-0.5) == 0 row -1) through the same first-event
        key comparison as the walk's scan, so the latched value is
        exactly the texel at the winning row. Out-of-texture events and
        fuel-capped pixels have CONCRETE per-start-row target rows and
        fold to static row selects. Only valid when the fetch's column
        mapping equals the walk's (the caller checks)."""
        h, w = self.h, self.w
        dev = self.device
        adj_i = int(round(adj))
        exact_adj = abs(adj - adj_i) < 1e-9

        def row_groups(rowvals, valid):
            """(h,) host target texture rows -> [(row, (h, 1) mask of
            the start rows reading it)]; invalid/OOB rows read black.
            None when too many distinct rows (a real gather)."""
            inr = valid & (rowvals >= 0) & (rowvals < h)
            uniq = np.unique(rowvals[inr])
            if uniq.size > 8:
                return None
            return [(int(r0), (inr & (rowvals == r0))[:, None])
                    for r0 in uniq]

        def host_plan():
            """The host-known half: row groups of the out-of-texture
            events and of the fuel-capped pixels (cached across frames
            under the walk's plan key)."""
            # out-of-texture events: per-start-row CONCRETE rows
            has = out_np != np.float32(SENT)
            oi = out_np.astype(np.int64)
            erow = (oi >> 1) + lo
            is_hit = (oi & 1) == bit_hit
            vfin = erow + frac + np.where(is_hit, float(adj_i), 0.0)
            # int casts truncate toward zero: (-1, 0) reads row 0 (the
            # int(-0.5) == 0 idiom); <= -1 reads OOB black
            outg = row_groups(np.trunc(vfin).astype(np.int64), has)
            # fuel-capped pixels: y = y0 + d*fuel_cap with y0 = row +
            # k + frac (the verified walk-entry structure)
            vf = (np.arange(h, dtype=np.float64) + k + frac
                  + d * fuel_cap)
            fuelg = row_groups(np.trunc(vf).astype(np.int64),
                               np.ones(h, bool))
            return outg, fuelg

        def row_select_planes(groups):
            """Row groups -> 4 (h, w) planes (texture row r lives at
            ext[r + 1])."""
            planes = [torch.zeros((h, w), device=dev) for _ in range(4)]
            for r0, m in groups:
                mt = compiled.const(m, dev)
                planes = [torch.where(mt, ext[ch][r0 + 1][None, :], p)
                          for ch, p in enumerate(planes)]
            return planes

        def latch(px_f):
            if not exact_adj:
                return None
            key = ("latch",) + plan_key
            groups = _plan_cache_get(key)
            if groups is None:
                groups = host_plan()
                _plan_cache_put(key, groups)
            outg, fuelg = groups
            if outg is None or fuelg is None:
                return None
            # candidate texel per extended row e (ext index e + 1): hit
            # events read tex[e + adj] (zero-fill shift; ext[0] already
            # encodes the row -1 truncation), cond exits tex[e]
            cands = []
            n = h + 1
            cond_t = compiled.const(condIN, dev)
            for ch in range(4):
                t = ext[ch]
                if adj_i == 0:
                    sh = t
                elif adj_i >= n or adj_i <= -n:
                    sh = torch.zeros_like(t)
                elif adj_i > 0:
                    sh = torch.cat([t[adj_i:],
                                    torch.zeros((adj_i, w), device=dev)], 0)
                else:
                    sh = torch.cat([torch.zeros((-adj_i, w), device=dev),
                                    t[:adj_i]], 0)
                cands.append(torch.where(cond_t, sh, t).contiguous())
            outs = latch_ops.latch_scan(kin, tuple(cands), d > 0, float(SENT))
            lat = list(outs[1:])
            # align with the walk decode: pad k rows, slice start rows
            if k:
                if d > 0:
                    pads = [torch.zeros((k, w), device=dev)] * 4
                else:
                    pads = [p[-1:].expand(k, w) for p in lat]
                lat = [torch.cat([p, pd], 0) for p, pd in zip(lat, pads)]
            lat = [p[k + 1:k + 1 + h] for p in lat]

            # identity-column branch decode (mirrors the walk's)
            fki = fkI.to(torch.int32)
            no_event = fkI == float(SENT)
            jstar = fki >> 1
            j0 = compiled.const((np.arange(h, dtype=np.int64)
                                 + (k - lo)).astype(np.int32), dev)[:, None]
            raw = (jstar - j0) * int(d)
            fuelled = no_event | (raw >= fuel_cap)
            took_out = (~no_event) & (fkI == compiled.const(
                out_np.astype(np.float32), dev)[:, None])
            outp = row_select_planes(outg)
            fuelp = row_select_planes(fuelg)

            vals = [torch.where(fuelled, fp, torch.where(took_out, op, lp))
                    for fp, op, lp in zip(fuelp, outp, lat)]

            # apply the fetch's column mapping (== the walk's); OOB
            # columns walked black texels and fetch at an OOB x: black
            if px_f[0] == "const":
                c = px_f[1]
                if 0 <= c < w:
                    vals = [v[:, c:c + 1].expand(h, w) for v in vals]
                else:
                    vals = [torch.zeros((h, w), device=dev) for _ in vals]
            elif px_f[1] != 0:
                vals = [_apply_axis(v, px_f, 1, w) for v in vals]
                if px_f[0] == "shift":
                    cols = np.arange(w) + px_f[1]
                    oobc = (cols < 0) | (cols >= w)
                    if oobc.any():
                        ob = compiled.const(oobc, dev)[None, :]
                        vals = [torch.where(ob, 0.0, v) for v in vals]
            _LATCH_HITS[0] += 1
            return tuple(vals)

        return latch

    def _while_loop(self, stmt: WhileLoop) -> None:
        """Masked data-dependent iteration (``ops.graph_while``).

        Per-pixel semantics (GLava runs real GLSL, e.g. graph's
        anti-alias column walk, graph/3.frag:24-54): each pixel iterates
        until its condition goes false or it breaks; the loop runs until
        every pixel has retired or the fuel cap is reached: eagerly, one
        host synchronisation per iteration, or, inside a capture, as a
        conditional while node with no host read. Variables assigned in
        the body that exist outside it are carried (canonicalized to
        (H, W) float32/bool planes, in buffers the body rewrites in
        place); body-local declarations are rebuilt every iteration and
        discarded afterwards."""
        # a VALUED return inside the loop merges into the enclosing
        # function's return value, which must then ride the loop state
        fr = self._fn_stack[-1] if self._fn_stack else None
        has_ret = (_contains_return(stmt.body)
                   or _contains_return(stmt.epilogue))
        carry_val = (fr is not None
                     and (_contains_return(stmt.body, valued=True)
                          or _contains_return(stmt.epilogue, valued=True)))
        env = self.env
        h, w = self.h, self.w
        dev = self.device
        # pass the loop NODE so its condition tokens are scanned too: a
        # global-writing helper called in the condition is carried too
        locals_, assigns = _collect_writes([stmt], self._user_funcs)
        pre = {n: (n in env.variables, env.variables.get(n))
               for n in (locals_ | assigns)}
        carried = sorted(n for n in (assigns - locals_)
                         if n in env.variables)
        # uniform-step walk detection needs the PRE-canon concrete
        # entry values (canon() turns them into device planes below)
        walk_info: dict[str, tuple[int, int, float]] = {}
        for n in carried:
            d = _walk_candidate(stmt, n, self._user_funcs)
            if d is None:
                continue
            ev = _walk_entry_value(env.variables[n], h, w)
            if ev is not None:
                walk_info[n] = (ev[0], d, ev[1])

        fuel_env = os.environ.get("GLAVA_TPU_WHILE_FUEL", "").strip()
        if fuel_env:
            try:
                fuel_cap = int(fuel_env)
                if fuel_cap <= 0:
                    raise ValueError
            except ValueError:
                raise ShaderError(
                    f"GLAVA_TPU_WHILE_FUEL must be a positive integer, "
                    f"got {fuel_env!r}"
                ) from None
        else:
            fuel_cap = 4 * (h + w) + self._WHILE_FUEL_BASE

        # first-hit walks collapse to column scans: no loop at all
        if walk_info and self._try_first_hit(stmt, carried, walk_info,
                                             fuel_cap):
            return

        def canon(v):
            if isinstance(v, glsl_expr.GlslArray):
                return glsl_expr.GlslArray([canon(e) for e in v.elems])
            if isinstance(v, glsl_expr.GlslStruct):
                return glsl_expr.GlslStruct(
                    v.typename, v.names, [canon(c) for c in v.vals])
            if isinstance(v, tuple):
                return tuple(canon(c) for c in v)
            a = self._t(v)
            if a.dtype != torch.bool:
                a = a.to(torch.float32)
            return a.expand(h, w)

        for n in carried:
            env.variables[n] = canon(env.variables[n])
        outer_mask = self.mask
        # the loop state lives in buffers made before the loop, written
        # in place by every iteration: a captured body (a while node,
        # ops.graph_while) replays at fixed addresses. Pixels still
        # active at the fuel cap retire with their current values
        # (hang-proofing, counted below)
        active = _bool_t(_band(outer_mask, self._cond_mask(stmt.cond)),
                         dev).expand(h, w).clone()
        fuel = torch.zeros(1, dtype=torch.int32, device=dev)
        vars_ = {n: _fresh(env.variables[n]) for n in carried}
        returned = torch.zeros((h, w), dtype=torch.bool, device=dev) \
            if has_ret else None
        fnval = None
        if carry_val:
            if fr["value"] is None:
                rt = fr.get("rettype", "float")
                fr["value"] = (self._zero_struct(rt) if rt in self._structs
                               else _zero_retval(rt, h, w, dev))
            fnval = _fresh(canon(fr["value"]))

        def body():
            for n in carried:
                env.variables[n] = vars_[n]
            if carry_val:
                fr["value"] = fnval
            ctx = {"broken": None, "continued": None}
            self._loop_stack.append(ctx)
            rctx = {"mask": torch.zeros((h, w), dtype=torch.bool, device=dev),
                    "fn_depth": len(self._fn_stack)}
            self._ret_stack.append(rctx)
            self.mask = active
            # register pristine walk-variable states: fetches indexed
            # by these exact objects are row-shifted slices, at the
            # device offset k + d * fuel
            _WALK_STACK.append([
                _WalkEntry(vars_[n], fuel[0] * d + k, frac > 0)
                for n, (k, d, frac) in walk_info.items()
            ])
            try:
                self.run(stmt.body)
                # `continue` lands here: continued pixels re-activate
                # for the epilogue (dynamic-for increment / do-while
                # condition check) and the next condition evaluation
                if ctx["continued"] is not None:
                    self.mask = _bor(self.mask, ctx["continued"])
                    ctx["continued"] = None
                self.run(stmt.epilogue)
                if ctx["continued"] is not None:
                    self.mask = _bor(self.mask, ctx["continued"])
            finally:
                _WALK_STACK.pop()
                self._loop_stack.pop()
                self._ret_stack.pop()
            dst = [active] + [vars_[n] for n in carried]
            src = [_bool_t(_band(self.mask, self._cond_mask(stmt.cond)),
                           dev).expand(h, w)]
            src += [canon(env.variables[n]) for n in carried]
            if has_ret:
                dst.append(returned)
                src.append(returned | _bool_t(rctx["mask"], dev))
            if carry_val:
                dst.append(fnval)
                src.append(canon(fr["value"]))
            _write_in_place(dst, src)
            fuel.add_(1)

        graph_while.run(active, fuel, fuel_cap, body,
                        warm=compiled.warming())
        # loud fuel-cap exhaustion: pixels still active when the cap
        # tripped were truncated mid-walk (a loop that ended before the
        # cap has none active); counted on the device, read on the host
        # by fuel_check (raises under GLAVA_TPU_WHILE_FUEL_STRICT=1)
        _fuel_add(active, fuel_cap)
        # loop-local writes vanish; carried writes commit
        for n, (had, old) in pre.items():
            if n in carried:
                continue
            if had:
                env.variables[n] = old
            else:
                env.variables.pop(n, None)
        for n in carried:
            env.variables[n] = vars_[n]
        if carry_val:
            fr["value"] = fnval
        if has_ret:
            # in-loop `return` retires pixels beyond the loop; chain
            # the plane into an enclosing while at the same fn depth
            self.mask = _band(outer_mask, ~returned)
            if (self._ret_stack
                    and self._ret_stack[-1]["fn_depth"]
                    == len(self._fn_stack)):
                rc = self._ret_stack[-1]
                rc["mask"] = _bor(rc["mask"], returned)
        else:
            # restore the EXACT pre-loop mask object: when it was the
            # pristine all-true mask, keeping its identity lets later
            # top-level assignments stay concrete numpy
            self.mask = outer_mask

    def _resolve_lvalue(self, target: str, items):
        """Descend a nested lvalue chain; returns (chain, leaf value)
        where chain is [(parent value, kind, evaluated key), ...]."""
        root = self.env.variables.get(target)
        if root is None:
            raise ShaderError(f"'{target}' used before assignment")
        chain: list[tuple] = []
        cur = root
        for kind, it in items:
            if kind == "m":
                if not isinstance(cur, (tuple, glsl_expr.GlslStruct)):
                    raise ShaderError(
                        f"cannot access member '.{it}' of a scalar "
                        f"in '{target}' lvalue chain")
                child = self._component(cur, it)
            else:
                it = self._eval(it)
                child = glsl_expr.index_value(cur, it)
            chain.append((cur, kind, it))
            cur = child
        return chain, cur

    @staticmethod
    def _rebuild_lvalue(chain, rhs):
        """Rebuild outward after replacing the leaf with ``rhs``."""
        for parent, kind, key in reversed(chain):
            if kind == "m":
                if isinstance(parent, glsl_expr.GlslStruct):
                    rhs = parent.replace(key, rhs)
                elif isinstance(parent, tuple):
                    idxs = [glsl_expr._SWIZZLE[c] for c in key]
                    comps = list(parent)
                    rt = (rhs if isinstance(rhs, tuple)
                          else (rhs,) * len(idxs))
                    if len(rt) != len(idxs):
                        raise ShaderError(
                            "swizzle assignment size mismatch")
                    for i, r in zip(idxs, rt):
                        comps[i] = r
                    rhs = tuple(comps)
                else:
                    raise ShaderError(
                        f"cannot assign member '.{key}' of a scalar")
            else:
                rhs = glsl_expr.index_store(parent, key, rhs)
        return rhs

    @staticmethod
    def _component(val, swizzle):
        if swizzle is None:
            return val
        if isinstance(val, glsl_expr.GlslStruct):
            return val.get(swizzle)
        idxs = [glsl_expr._SWIZZLE[c] for c in swizzle]
        if len(idxs) == 1:
            return val[idxs[0]]
        return tuple(val[i] for i in idxs)
# what evaluating an expression over a domain it was not written for
# can raise (ExprError and ShaderError are ValueErrors): the fast
# lowerings then decline and the general one runs
_EVAL_ERRORS = (TypeError, ValueError, IndexError)


class _DynamicBound(Exception):
    """Internal: a for-loop bound evaluated to per-pixel data."""


def _collect_writes(body, funcs: dict | None = None,
                    _seen: set | None = None) -> tuple[set, set]:
    """(declared names, assigned names) across a statement tree.

    When ``funcs`` (name -> FuncDef) is given, calls to user functions
    found in expression token streams contribute the GLOBALS those
    functions write (their assigns minus their own params/locals,
    transitively) — a helper like ``void bump() { g += 1; }`` invoked
    inside a while body mutates ``g`` across iterations, so ``g`` must
    ride the loop carry."""
    funcs = funcs or {}
    decls: set = set()
    assigns: set = set()
    seen_funcs: set = set() if _seen is None else _seen

    def fn_globals(name: str) -> set:
        if name in seen_funcs:
            return set()
        seen_funcs.add(name)
        fdef = funcs[name]
        d, a = _collect_writes(fdef.body, funcs, seen_funcs)
        return a - d - set(fdef.params)

    def out_arg_roots(toks, i, fdef):
        """Caller variables written via out/inout args of the call at
        toks[i] (ident) — they must count as assigned at the call
        site (e.g. to ride a surrounding while-loop's carry)."""
        outs = [j for j, q in enumerate(fdef.quals or ())
                if q in ("out", "inout")]
        if not outs or i + 1 >= len(toks) or toks[i + 1][1] != "(":
            return
        depth = 0
        j = i + 1
        arg_slices = []
        cur_start = i + 2
        while j < len(toks):
            v = toks[j][1]
            if v == "(":
                depth += 1
            elif v == ")":
                depth -= 1
                if depth == 0:
                    arg_slices.append(toks[cur_start:j])
                    break
            elif v == "," and depth == 1:
                arg_slices.append(toks[cur_start:j])
                cur_start = j + 1
            j += 1
        for oi in outs:
            if oi < len(arg_slices):
                path = _lvalue_path(arg_slices[oi])
                if path is not None:
                    assigns.add(path[0])

    def scan_tokens(toks):
        if not toks:
            return
        for i, (k, v) in enumerate(toks):
            if (k == "ident" and v in funcs
                    and i + 1 < len(toks) and toks[i + 1][1] == "("):
                assigns.update(fn_globals(v))
                out_arg_roots(toks, i, funcs[v])

    def walk(stmts):
        for s in stmts:
            if isinstance(s, Decl):
                decls.update(n for n, _i, _a in s.names)
                for _n, init, arr in s.names:
                    scan_tokens(init)
                    scan_tokens(arr)
            elif isinstance(s, Assign):
                assigns.add(s.target)
                scan_tokens(s.expr)
                scan_tokens(s.index)
            elif isinstance(s, AssignPath):
                assigns.add(s.target)
                scan_tokens(s.expr)
                for kind, it in s.items:
                    if kind == "i":
                        scan_tokens(it)
            elif isinstance(s, Switch):
                scan_tokens(s.expr)
                for labels, body in s.cases:
                    for lab in labels or ():
                        scan_tokens(lab)
                    walk(body)
            elif isinstance(s, If):
                scan_tokens(s.cond)
                walk(s.then)
                walk(s.other)
            elif isinstance(s, ForLoop):
                assigns.add(s.var)
                scan_tokens(s.start)
                scan_tokens(s.bound)
                scan_tokens(s.step)
                walk(s.body)
            elif isinstance(s, WhileLoop):
                scan_tokens(s.cond)
                walk(s.body)
                walk(s.epilogue)
            elif isinstance(s, ExprStmt):
                scan_tokens(s.expr)
            elif isinstance(s, Return):
                scan_tokens(s.expr)

    walk(body)
    return decls, assigns


def _contains_return(body, valued: bool = False) -> bool:
    """Any Return in the tree (``valued=True``: only value-carrying
    ones). Nested function *bodies* live in their own FuncDefs, so
    every Return found here belongs to the current function level."""
    for s in body:
        if isinstance(s, Return) and (not valued or s.expr is not None):
            return True
        if isinstance(s, If) and (_contains_return(s.then, valued)
                                  or _contains_return(s.other, valued)):
            return True
        if isinstance(s, (ForLoop, WhileLoop)) \
                and (_contains_return(s.body, valued)
                     or _contains_return(getattr(s, "epilogue", []) or [],
                                         valued)):
            return True
        if isinstance(s, Switch) and any(
                _contains_return(b, valued) for _, b in s.cases):
            return True
    return False



def _zero_retval(rettype: str, h: int, w: int, device):
    """Typed zero for a function return value that must ride a loop's
    state before any return site has executed (GLSL leaves the value
    of a never-returning path undefined; zeros match _merge_masked's
    no-prior default)."""
    plane = torch.zeros((h, w), device=device)
    ncomp = {"vec2": 2, "vec3": 3, "vec4": 4}.get(rettype)
    return tuple(plane for _ in range(ncomp)) if ncomp else plane


# ---------------------------------------------------------------------------
# Uniform-step walk route.
#
# The graph anti-alias walks (graph/3.frag get_col_height_up/_down), and
# any user shader of the same shape, iterate a variable `y` that (a)
# starts as the pixel's own row coordinate (a CONCRETE numpy plane) and
# (b) is stepped by the same constant +-d on every iteration for every
# still-active pixel (other writes are immediately followed by
# `break`/`return`, so they only set retired pixels' final values).
# For such a variable, at iteration i every ACTIVE pixel has exactly
# y = y0 + d*i, so ``texelFetch(prev, ivec2(col + dx, y))`` is a
# VERTICAL SHIFT of a fixed plane by d*i: a slice, not a gather.
#
# Correctness notes:
# - Retired pixels' y diverges from y0 + d*i, but their mask is off:
#   every downstream write is `where(mask, new, old)`.
# - The registry matches the iteration-start state object by
#   identity; any in-body assignment makes a new object, which takes
#   the general fetch routes.
# - ivec2 truncates toward zero. For y0 = row + c0 with c0 >= 0,
#   trunc(y0 + d*i) == row + floor(c0) + d*i whenever y0 + d*i >= 0;
#   for y0 + d*i in (-1, 0) GL's int cast yields 0 (row 0), which the
#   padded plane reproduces by placing one copy of row 0 at offset -1
#   when frac(c0) > 0 (see _walk_shifted_prev).
# ---------------------------------------------------------------------------

_WALK_STACK: list[list] = []  # frames of _WalkEntry, innermost loop last
_WALK_HITS = [0]              # diagnostic: first-hit scans and walk-shift fetches
_PROV_HITS = [0]              # diagnostic: fetches resolved via provenance
_LATCH_HITS = [0]             # diagnostic: walk texels via the latch scan
_CURRENT_EXEC = None          # the _Exec whose pass is running


@dataclass
class _WalkEntry:
    obj: object       # the iteration-start state plane (matched with `is`)
    offset: Any       # floor(c0) + d*i at this iteration: an int32 tensor
    fracpos: bool     # frac(c0) > 0: int(-0.5) == 0 needs the -1 row


def _walk_step_delta(s, name: str) -> float | None:
    """Constant step delta if `s` is ``name += c`` / ``name -= c`` /
    ``name = name ± c`` (scalar, no swizzle/index), else None."""
    if not isinstance(s, Assign) or s.target != name:
        return None
    if s.swizzle is not None or s.index is not None:
        return None
    toks = [t for t in s.expr if t[0] != "end"]
    if s.op in ("+=", "-="):
        if len(toks) == 1 and toks[0][0] == "num":
            d = float(toks[0][1])
            return -d if s.op == "-=" else d
        return None
    if s.op == "=" and len(toks) == 3:
        a, op, b = toks
        if (a == ("ident", name) and op[0] == "op" and op[1] in "+-"
                and b[0] == "num"):
            d = float(b[1])
            return -d if op[1] == "-" else d
        if (a[0] == "num" and op == ("op", "+") and b == ("ident", name)):
            return float(a[1])
    return None


def _walk_candidate(stmt: WhileLoop, name: str,
                    user_funcs: dict | None) -> int | None:
    """Integer step delta d if every active pixel steps `name` by
    exactly d once per iteration of `stmt`, else None.

    Requirements: the LAST top-level body statement is the (single)
    unconditional step write; every other write to `name` is
    immediately followed by `break`/`return` in its block (it only
    sets a retiring pixel's final value); no `continue` (it would skip
    the step); no write via nested loops or global-writing helper
    calls; the epilogue does not touch `name` (pure `while` only)."""
    if stmt.epilogue:
        return None
    body = stmt.body
    if not body:
        return None
    d = _walk_step_delta(body[-1], name)
    if d is None or d != int(d) or d == 0:
        return None

    funcs = user_funcs or {}
    ok = True

    def fn_writes_name(fname: str, seen: set) -> bool:
        if fname in seen:
            return False
        seen.add(fname)
        fdef = funcs[fname]
        decls, assigns = _collect_writes(fdef.body, funcs)
        return name in (assigns - decls - set(fdef.params))

    def scan_tokens(toks):
        nonlocal ok
        if not toks:
            return
        for i, (k, v) in enumerate(toks):
            if (k == "ident" and v in funcs and i + 1 < len(toks)
                    and toks[i + 1][1] == "(" and fn_writes_name(v, set())):
                ok = False

    def walk(stmts):
        nonlocal ok
        for i, s in enumerate(stmts):
            if not ok:
                return
            if isinstance(s, Continue):
                ok = False
            elif isinstance(s, Assign):
                scan_tokens(s.expr)
                scan_tokens(s.index)
                if s.target != name:
                    continue
                # every write other than the final step (body[-1],
                # excluded from this walk) must be a "final" write:
                # the next statement in its block retires the pixel
                nxt = stmts[i + 1] if i + 1 < len(stmts) else None
                if not isinstance(nxt, (Break, Return)):
                    ok = False
            elif isinstance(s, Decl):
                for n, init, arr in s.names:
                    scan_tokens(init)
                    scan_tokens(arr)
                    if n == name:
                        ok = False  # shadowing: too subtle, bail
            elif isinstance(s, If):
                scan_tokens(s.cond)
                walk(s.then)
                walk(s.other)
            elif isinstance(s, (ForLoop, WhileLoop)):
                _d, a = _collect_writes([s], funcs)
                if name in a or name in _d:
                    ok = False
                # fetches inside nested loops use their own carry
                # objects — no scan needed beyond the write check
            elif isinstance(s, ExprStmt):
                scan_tokens(s.expr)
            elif isinstance(s, Return):
                scan_tokens(s.expr)

    walk(body[:-1])
    scan_tokens(stmt.cond)
    return int(d) if ok else None


def _walk_entry_value(val, h: int, w: int) -> tuple[int, float] | None:
    """(floor(c0), frac(c0)) if `val` is a concrete numpy plane of
    the form row_index + c0 with constant c0 >= 0, else None."""
    if isinstance(val, (tuple, glsl_expr.GlslArray)) or _is_t(val):
        return None
    try:
        a = np.broadcast_to(np.asarray(val, np.float64), (h, w))
    except _EVAL_ERRORS:
        return None
    col = a[:, 0]
    if not np.array_equal(a, np.broadcast_to(col[:, None], (h, w))):
        return None
    c0 = float(col[0])
    if c0 < 0 or not np.array_equal(col, np.arange(h, dtype=np.float64) + c0):
        return None
    return int(np.floor(c0)), float(c0 % 1.0)


def _split_call(toks, fname: str) -> list[list] | None:
    """Top-level argument token lists of ``fname(...)``, else None."""
    toks = [t for t in toks if t[0] != "end"]
    if (len(toks) < 3 or toks[0] != ("ident", fname)
            or toks[1] != ("op", "(") or toks[-1] != ("op", ")")):
        return None
    args, cur, depth = [], [], 0
    for t in toks[2:-1]:
        if t == ("op", "("):
            depth += 1
        elif t == ("op", ")"):
            depth -= 1
            if depth < 0:
                return None
        if t == ("op", ",") and depth == 0:
            args.append(cur)
            cur = []
        else:
            cur.append(t)
    if depth != 0:
        return None
    args.append(cur)
    return args


# pure elementwise math builtins: safe to evaluate over an extended
# (rows, w) domain inside the first-hit lowering
_PURE_FNS = frozenset((
    "abs", "min", "max", "clamp", "floor", "ceil", "fract", "sign",
    "step", "smoothstep", "mix", "pow", "exp", "log", "exp2", "log2",
    "sqrt", "inversesqrt", "sin", "cos", "tan", "float", "int", "bool",
))


def _idents_allowed(toks, plain_ok) -> bool:
    """Every identifier in `toks` is either a pure math builtin call,
    a swizzle component (preceded by '.'), or passes `plain_ok`."""
    toks = [t for t in (toks or []) if t[0] != "end"]
    for i, (k, v) in enumerate(toks):
        if k != "ident":
            continue
        if i > 0 and toks[i - 1] == ("op", "."):
            continue  # swizzle component
        if i + 1 < len(toks) and toks[i + 1] == ("op", "("):
            if v not in _PURE_FNS:
                return False
            continue
        if not plain_ok(v):
            return False
    return True


def _scalar_like(v) -> bool:
    if isinstance(v, (bool, int, float, np.number)):
        return True
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return True
    if isinstance(v, tuple):
        return all(_scalar_like(c) for c in v)
    return False



_FUEL_WARN_STATE = {"last": 0.0, "read": 0.0}
# device (with its index, _fuel_device) -> [int64 count of truncated
# pixels, the last fuel cap]
_FUEL: dict = {}


def _fuel_device(device) -> torch.device:
    """``device`` as the counters are keyed: a card with its index
    (``cuda`` is the current card, as a tensor made there says)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _fuel_add(plane: torch.Tensor, cap: int) -> None:
    """Add the pixels of ``plane`` (those a loop truncated at the fuel
    cap) to its device's counter, on the device. The eager step reads
    it at once; a compiled step's caller reads it with
    :func:`fuel_check` (the counterpart of the JAX interpreter's
    ``jax.debug.callback``)."""
    if not _fuel_warn():
        return
    key = _fuel_device(plane.device)
    entry = _FUEL.get(key)
    if entry is None:
        entry = _FUEL[key] = [
            torch.zeros((), dtype=torch.int64, device=plane.device), cap]
    entry[0].add_(plane.sum())
    entry[1] = cap
    if not compiled.in_step():
        fuel_check(plane.device, force=True)


def fuel_check(device=None, force: bool = False) -> int:
    """Read the truncated-pixel counters (of ``device``, or of every
    device), zero them and report their sum (:func:`_fuel_report`:
    raises under GLAVA_TPU_WHILE_FUEL_STRICT=1); one host
    synchronisation, at most once a second unless ``force``. Returns
    the count read (0 when held off)."""
    now = _time.monotonic()
    if not force and now - _FUEL_WARN_STATE["read"] < 1.0:
        return 0
    _FUEL_WARN_STATE["read"] = now
    ts = profiling.begin()
    total, cap = 0, 0
    want = None if device is None else _fuel_device(device)
    for dev, entry in _FUEL.items():
        if want is not None and dev != want:
            continue
        n = int(entry[0])
        if n:
            entry[0].zero_()
            total += n
            cap = entry[1]
    if ts:
        profiling.end("fuel", ts, total)
    _fuel_report(total, cap)
    return total


def _fuel_report(count: int, cap: int) -> None:
    """Loud fuel-cap exhaustion (count of truncated pixels). Raises
    under GLAVA_TPU_WHILE_FUEL_STRICT=1; otherwise one stderr line,
    throttled to one a second."""
    if count == 0:
        return
    msg = (f"glava_tpu_torch: while-loop fuel cap ({int(cap)}) exhausted "
           f"with {count} pixel(s) still active — their output is "
           f"truncated at the last completed iteration; raise "
           f"GLAVA_TPU_WHILE_FUEL")
    if os.environ.get("GLAVA_TPU_WHILE_FUEL_STRICT", "") == "1":
        raise RuntimeError(msg)
    now = _time.monotonic()
    if now - _FUEL_WARN_STATE["last"] >= 1.0:
        _FUEL_WARN_STATE["last"] = now
        print(msg, file=sys.stderr)


def _fuel_warn() -> bool:
    """Fuel reports on (each costs a host synchronisation);
    GLAVA_TPU_WHILE_FUEL_WARN=0 turns them off."""
    return os.environ.get("GLAVA_TPU_WHILE_FUEL_WARN", "1") != "0"


def _lvalue_path(toks):
    """Parse an argument token slice as an lvalue: ``ident (('.' m) |
    ('[' ... ']'))*`` -> (name, items) for :meth:`_Exec._resolve_lvalue`,
    or None when the tokens are not a plain lvalue chain."""
    tl = [t for t in toks if t[0] != "end"]
    if not tl or tl[0][0] != "ident":
        return None
    name = tl[0][1]
    items = []
    i = 1
    while i < len(tl):
        k, v = tl[i]
        if v == "." and i + 1 < len(tl) and tl[i + 1][0] == "ident":
            items.append(("m", tl[i + 1][1]))
            i += 2
        elif v == "[":
            depth = 1
            j = i + 1
            while j < len(tl) and depth:
                if tl[j][1] == "[":
                    depth += 1
                elif tl[j][1] == "]":
                    depth -= 1
                j += 1
            if depth:
                return None
            items.append(("i", tl[i + 1:j - 1] + [("end", "")]))
            i = j
        else:
            return None
    return name, items


def _merge_masked(mask, new, old):
    """Per-pixel merge of a return value at one return site."""
    if isinstance(new, glsl_expr.GlslStruct):
        if old is None:
            old = glsl_expr.GlslStruct(
                new.typename, new.names,
                [(tuple(0.0 for _ in v) if isinstance(v, tuple) else 0.0)
                 for v in new.vals])
        return glsl_expr.GlslStruct(
            new.typename, new.names,
            [_merge_masked(mask, a, b)
             for a, b in zip(new.vals, old.vals)])
    if old is None:
        old = (tuple(0.0 for _ in new) if isinstance(new, tuple) else 0.0)

    def sel(n, o):
        return _where(mask, n, o)

    # the mask is per-pixel even when the returned value is scalar
    return glsl_expr._map2(sel, sel, new, old)


def _fresh(v):
    """A loop buffer for a canonical carried value (tensors, tuples,
    arrays and structs of them): new contiguous tensors with its value."""
    if isinstance(v, glsl_expr.GlslArray):
        return glsl_expr.GlslArray([_fresh(e) for e in v.elems])
    if isinstance(v, glsl_expr.GlslStruct):
        return glsl_expr.GlslStruct(v.typename, v.names,
                                    [_fresh(c) for c in v.vals])
    if isinstance(v, tuple):
        return tuple(_fresh(c) for c in v)
    return v.clone(memory_format=torch.contiguous_format)


def _leaves(v) -> list:
    if isinstance(v, glsl_expr.GlslArray):
        v = v.elems
    elif isinstance(v, glsl_expr.GlslStruct):
        v = v.vals
    if isinstance(v, (tuple, list)):
        return [t for c in v for t in _leaves(c)]
    return [v]


def _write_in_place(dst: list, src: list) -> None:
    """``d.copy_(s)`` for each buffer and its new value (matching
    structures), every new value that shares memory with a buffer
    copied first (a carried swap must not read a buffer it wrote)."""
    dl = [t for d in dst for t in _leaves(d)]
    sl = [t for s in src for t in _leaves(s)]
    if len(dl) != len(sl):
        raise ShaderError("a loop-carried value changed its structure")
    mem = {t.untyped_storage().data_ptr() for t in dl}
    sl = [t.clone() if t.untyped_storage().data_ptr() in mem else t
          for t in sl]
    for d, t in zip(dl, sl):
        d.copy_(t)


def _np_like_val(x) -> bool:
    """Per-pixel or runtime data (a plane, or any tensor) as opposed to
    a host scalar: decides static for-loop bounds and array sizes."""
    return _is_t(x) or (hasattr(x, "shape") and getattr(x, "ndim", 0) != 0)


def _bin(a, b, op):
    if op in ("<<", ">>", "&", "|", "^"):
        f = {"<<": lambda x, y: x << y, ">>": lambda x, y: x >> y,
             "&": lambda x, y: x & y, "|": lambda x, y: x | y,
             "^": lambda x, y: x ^ y}[op]
        return glsl_expr._int_map2(f, a, b)
    if op == "%":  # same semantics as the expression-level '%'
        return glsl_expr._map2(lambda x, y: math.fmod(x, y),
                               glsl_expr._tnp().mod, a, b)
    f = {"+": lambda x, y: x + y, "-": lambda x, y: x - y,
         "*": lambda x, y: x * y, "/": lambda x, y: x / y}[op]
    return glsl_expr._map2(f, f, a, b)


# ---------------------------------------------------------------------------
# host plans cached across frames
#
# The interpreter re-runs every pass each frame, so planning that
# depends only on host-known values (the first-hit walk's extended
# domain, the latch's row groups, static lookups' device index planes)
# is cached here, keyed by everything it depends on. LRU-bounded: a
# process cycling many shaders or geometries must not grow without
# bound.
# ---------------------------------------------------------------------------

_PLAN_CACHE: collections.OrderedDict = collections.OrderedDict()
_PLAN_CACHE_MAX = 256


def _plan_cache_get(key):
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE.move_to_end(key)
    return plan


def _plan_cache_put(key, plan) -> None:
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)


# static table lookups keyed by their index plane's content: a cheap
# fingerprint picks the bucket, np.array_equal confirms
_STATIC_LK_CACHE: collections.OrderedDict = collections.OrderedDict()
_STATIC_LK_CACHE_MAX = 32


def _static_lookup_cached(idx: np.ndarray, size: int, device):
    """``StaticLookup`` for a host-known index plane (values already in
    [0, size)), built once per plane content and device."""
    idx = np.ascontiguousarray(idx, np.int32)
    flat = idx.reshape(-1)
    step = max(1, flat.size // 4096)
    key = (size, idx.shape, str(device),
           hashlib.sha1(flat[::step].tobytes()).digest())
    hit = _STATIC_LK_CACHE.get(key)
    if hit is not None and np.array_equal(hit[0], idx):
        _STATIC_LK_CACHE.move_to_end(key)
        compiled.hold(hit[1])    # the cache may let it go; a graph may not
        return hit[1]
    lk = lookup_ops.StaticLookup(idx, size, device)
    compiled.hold(lk)
    _STATIC_LK_CACHE[key] = (idx, lk)
    while len(_STATIC_LK_CACHE) > _STATIC_LK_CACHE_MAX:
        _STATIC_LK_CACHE.popitem(last=False)
    return lk


def _fetch_1d(tex, i, sz: int):
    """``tex[clip(i, 0, sz - 1)]``: host-known (numpy) index planes go
    through a cached ``ops.lookup.StaticLookup``, runtime (tensor) ones
    through ``ops.lookup.fetch_1d``; both are the table lookup kernel
    on the card."""
    if isinstance(i, (np.ndarray, np.generic, int, float)):
        ic = np.asarray(i)
        if ic.dtype != np.int32:   # int32 planes clip without a copy to int64
            ic = ic.astype(np.int64)
        ic = np.clip(ic, 0, sz - 1)
        return _static_lookup_cached(ic, sz, tex.device)(tex)
    return lookup_ops.fetch_1d(tex, glsl_expr._tensor(i, tex.device), sz)


def _axis_pattern(vals, n):
    """Classify a constant index vector along one axis.

    Returns ('shift', d) for ``arange + d`` (out-of-range reads are
    transparent black, matching robust texelFetch), or
    ('clamp0', d) for ``max(arange + d, 0)`` — the pattern float
    coordinates produce under GLSL's truncate-toward-zero int cast
    (e.g. ``ivec2(gl_FragCoord.x - 1, ...)``: int(-0.5) == 0), or
    ('wrap', d) for ``(arange + d) mod n`` (GL_REPEAT), or
    ('const', c) for a constant index vector, or None."""
    base = np.arange(n, dtype=np.int64)
    v = vals.astype(np.int64)
    if np.all(v == v[0]):
        return ("const", int(v[0]))
    d = int(v[n // 2]) - (n // 2)
    if np.array_equal(v, base + d):
        return ("shift", d)
    if d < 0 and np.array_equal(v, np.maximum(base + d, 0)):
        return ("clamp0", d)
    dw = int(v[0]) % n
    if np.array_equal(v, (base + dw) % n):
        return ("wrap", dw)
    return None


def _fits(shape, h: int, w: int) -> bool:
    """Whether ``shape`` broadcasts to the (h, w) pixel grid."""
    try:
        return np.broadcast_shapes(shape, (h, w)) == (h, w)
    except ValueError:
        return False


def _col_pattern(x, h: int, w: int):
    """Axis pattern of a host-known x index plane that is the same in
    every row (a per-column pattern), else None. Checked on the array's
    own shape, so a broadcastable (1, W) plane costs O(W)."""
    xn = np.asarray(x)
    if xn.ndim > 2 or not _fits(xn.shape, h, w):
        return None
    if xn.ndim == 2 and xn.shape[0] > 1 and not np.array_equal(
            xn, np.broadcast_to(xn[0:1, :], xn.shape)):
        return None
    return _axis_pattern(np.broadcast_to(xn, (h, w))[0], w)


def _row_pattern(y, h: int, w: int):
    """Axis pattern of a host-known y index plane that is the same in
    every column, else None."""
    yn = np.asarray(y)
    if yn.ndim > 2 or not _fits(yn.shape, h, w):
        return None
    if yn.ndim == 2 and yn.shape[1] > 1 and not np.array_equal(
            yn, np.broadcast_to(yn[:, 0:1], yn.shape)):
        return None
    return _axis_pattern(np.broadcast_to(yn, (h, w))[:, 0], h)


def _apply_axis(arr, pat, axis, n):
    """Apply a classified axis pattern to a tensor: out[c] = arr[c + d]
    (shift, out-of-range reads 0), arr[max(c + d, 0)] (clamp0),
    arr[(c + d) mod n] (wrap) or arr[d] (const, out-of-range 0)."""
    kind, d = pat
    idx = [slice(None)] * arr.ndim
    if kind == "const":  # out[c] = arr[d] for every c (OOB reads 0)
        if d < 0 or d >= n:
            return torch.zeros_like(arr)
        idx[axis] = slice(d, d + 1)
        shape = list(arr.shape)
        shape[axis] = n
        return arr[tuple(idx)].expand(shape)
    if d == 0:
        return arr
    if kind == "wrap":  # out[c] = arr[(c + d) mod n], 0 < d < n
        hi = [slice(None)] * arr.ndim
        idx[axis] = slice(d, n)
        hi[axis] = slice(0, d)
        return torch.cat([arr[tuple(idx)], arr[tuple(hi)]], dim=axis)
    if kind == "clamp0":  # out[c] = arr[max(c + d, 0)], d < 0
        idx[axis] = slice(0, 1)
        edge = arr[tuple(idx)]
        if d <= -n:  # every index clamps to 0
            return torch.cat([edge] * n, dim=axis)
        idx[axis] = slice(0, n + d)
        return torch.cat([edge] * (-d) + [arr[tuple(idx)]], dim=axis)
    # pure shift: out[c] = arr[c + d], out-of-range reads 0
    if abs(d) >= n:  # everything out of range
        return torch.zeros_like(arr)
    pad_shape = list(arr.shape)
    pad_shape[axis] = abs(d)
    zeros = torch.zeros(pad_shape, dtype=arr.dtype, device=arr.device)
    if d > 0:
        idx[axis] = slice(d, n)
        return torch.cat([arr[tuple(idx)], zeros], dim=axis)
    idx[axis] = slice(0, n + d)
    return torch.cat([zeros, arr[tuple(idx)]], dim=axis)


# ---------------------------------------------------------------------------
# builtin functions bound per frame
# ---------------------------------------------------------------------------

def make_builtins(prev, sz: int, h: int, w: int, smooth_fetch, device):
    """Texture/sampling builtins closing over this frame's inputs.

    ``smooth_fetch(tex, pos)`` is the per-pixel smooth_audio evaluator
    (``render/modules/glsl_module._per_pixel_sampler``). Texture arguments
    arrive as the evaluated uniform values: (sz,) tensors for audio
    textures, the string marker "prev" for the previous pass's
    sampler2D. ``prev`` is the previous pass's channel planes
    (render/base.py's planar frame convention).

    ``texelFetch(prev, ...)`` takes the first route that applies, in
    this order: a constant shift of the pixel grid (slices), a
    uniform-step walk variable (a row-shifted slice), a plane with
    fetch provenance (first-hit walk results: the latch scan, else the
    row-wise lookup, merged through masked selects), a per-column x at a
    runtime y (the row-wise lookup, four channels a launch), else a 2-D
    gather. Values created here are per pass and frame, so the
    loop-invariant planes the routes build are cached in this closure.
    """
    dev = torch.device(device)

    def plane(p):
        # every route reads (h, w) float32 planes of one layout (the
        # row-wise lookup takes its four tables in one layout)
        return glsl_expr._tensor(p, dev).to(torch.float32) \
            .expand(h, w).contiguous()

    if prev is not None:
        prev = tuple(plane(p) for p in prev)
    memo: dict = {}

    def cached(key, make):
        # a value made while a loop body is captured lives in that
        # body's graph: made anew there, never kept for later
        if graph_while.capturing_body():
            return memo[key] if key in memo else make()
        if key not in memo:
            memo[key] = make()
        return memo[key]

    def _norm_idx(c, n):
        """Normalized coord -> NEAREST texel index with REPEAT wrap
        (the prev FBO texture is GL_NEAREST, render.c:545-547, with
        the GL default GL_REPEAT wrap), numpy-preserving."""
        if isinstance(c, (np.ndarray, np.generic, int, float)):
            c32 = np.asarray(c).astype(np.float32)
            u = c32 - np.floor(c32)
            return np.minimum(np.floor(u * np.float32(n)),
                              n - 1).astype(np.int32)
        c = glsl_expr._tensor(c, dev)
        if not c.is_floating_point():
            c = c.to(torch.float32)
        u = c - torch.floor(c)
        return torch.clamp(torch.floor(u * n), max=n - 1).to(torch.int32)

    def _rgba(v):
        return (v, torch.zeros_like(v), torch.zeros_like(v),
                torch.ones_like(v))

    def texture(tex, x):
        # NEAREST + REPEAT (render.c:512-517); audio textures are
        # single-channel GL_R16 -> vec4(r, 0, 0, 1)
        if isinstance(tex, str) and tex == "prev":
            # sampler2D prev: normalized vec2 -> texel indices, then
            # the texelFetch routing
            if not (isinstance(x, tuple) and len(x) == 2):
                raise ShaderError("texture() on prev needs vec2 "
                                  "coordinates")
            return texelFetch(
                "prev", (_norm_idx(x[0], w), _norm_idx(x[1], h)), 0)
        return _rgba(_fetch_1d(tex, _norm_idx(x, sz), sz))

    def _prev_const_shift(xi, yi):
        """Per-axis patterns when the fetch is the pixel grid offset by
        constants: identity fetches (every premultiply/post pass) and
        neighbour taps (outline/highlight passes). gl_FragCoord enters
        the interpreter as host numpy, so coordinate math stays
        inspectable."""
        if _is_t(xi) or _is_t(yi):
            return None
        px = _col_pattern(xi, h, w)
        py = _row_pattern(yi, h, w)
        if px is None or py is None:
            return None
        return px, py

    def _shifted_prev(px, py):
        return cached(("shift", px, py), lambda: tuple(
            _apply_axis(_apply_axis(p, py, 0, h), px, 1, w) for p in prev))

    def _walk_match(v):
        for frame in reversed(_WALK_STACK):
            for e in frame:
                if v is e.obj:
                    return e
        return None

    def _col_shifted(px):
        """prev with the per-column x pattern applied (loop-invariant)."""
        return cached(("col", px),
                      lambda: tuple(_apply_axis(p, px, 1, w) for p in prev))

    def _walk_shifted_prev(xi, yi):
        """``texelFetch(prev, ivec2(col + dx, y))`` where y is a
        registered uniform-step walk variable (see the _WALK_STACK
        block comment): at iteration i every ACTIVE pixel reads row
        (own_row + k + d*i), a vertical slice of the column-shifted
        prev. Retired lanes receive stale values; their mask discards
        every downstream write. Row -1 reads row 0 when the walk value
        carries a positive fraction (GL's int cast: int(-0.5) == 0);
        all other out-of-range rows read transparent black, matching
        the robust-access texelFetch behaviour."""
        e = _walk_match(yi)
        if e is None or _is_t(xi):
            return None
        px = _col_pattern(xi, h, w)
        if px is None:
            return None

        def padded():
            # [h zero rows, near row, the plane, h zero rows]: row -1
            # of the plane sits at h, row 0 at h + 1
            out = []
            for ch in _col_shifted(px):
                z = torch.zeros((h, w), dtype=ch.dtype, device=dev)
                near = ch[0:1] if e.fracpos else z[0:1]
                out.append(torch.cat([z, near, ch, z], dim=0))
            return tuple(out)

        # clip range [-(h+1), h]: offsets beyond either end are fully
        # out of range for EVERY row, and -(h+1) keeps one all-black
        # row below the fracpos near row so a deeper-than-h walk does
        # not alias onto the int(-0.5)==0 row-0 copy. The offset is a
        # device int32 (it moves with the loop's fuel), so the rows are
        # gathered, not sliced
        s = torch.clamp(e.offset, -(h + 1), h)
        rows = torch.arange(h + 1, 2 * h + 1, dtype=torch.int32,
                            device=dev) + s
        planes = cached(("walk", px, e.fracpos), padded)
        _WALK_HITS[0] += 1
        return tuple(torch.index_select(p, 0, rows) for p in planes)

    def _ext_texels(px, fracpos: bool, lo: int, hi: int):
        """Texel planes of the column-patterned prev over EXTENDED
        rows e in [lo, hi) (lo <= -1, hi >= h): texture rows pass
        through, row -1 reads row 0 when the walk value carries a
        positive fraction (int(-0.5) == 0), every other out-of-range
        row is transparent black. Feeds the first-hit walk lowering in
        _Exec._try_first_hit (which has already classified the column
        pattern `px`)."""
        if prev is None:
            return None
        out = []
        for b in _col_shifted(px):
            z = lambda n: torch.zeros((n, w), dtype=b.dtype,  # noqa: E731
                                      device=dev)
            nearrow = b[0:1] if fracpos else z(1)
            parts = ([z(-1 - lo)] if lo < -1 else []) + [nearrow, b]
            if hi > h:
                parts.append(z(hi - h))
            out.append(torch.cat(parts, dim=0))
        return tuple(out)

    def _col_aligned_prev(xi, yi):
        """``texelFetch(prev, ivec2(col + d, y))`` with a RUNTIME y and
        a host-known per-column x: each source column is the private
        table of one output column, the row-wise lookup."""
        if _is_t(xi) or not _is_t(yi):
            return None
        px = _col_pattern(xi, h, w)
        if px is None:
            return None
        return _col_fetch(px, yi)

    def _col_fetch(px, yi):
        """Column-patterned fetch at a runtime y plane through
        ``ops.lookup.rowwise_lookup`` (bit-exact with the gather), the
        four channels in one launch (C = 4): the tables are the columns
        of the column-shifted prev, read through ``.T`` views, the index
        plane y's ``.T`` view."""
        shifted = _col_shifted(px)
        yi32 = glsl_expr._tensor(yi, dev).to(torch.int32).expand(h, w)
        inside = (yi32 >= 0) & (yi32 < h)   # y OOB: transparent black
        idx_t = torch.clamp(yi32, 0, h - 1).T
        outs = lookup_ops.rowwise_lookup(tuple(p.T for p in shifted), idx_t)
        return tuple(torch.where(inside, o.T, 0.0) for o in outs)

    def _general_fetch(xi, yi):
        """Reference-semantics fetch at arbitrary index planes (a 2-D
        gather per channel)."""
        xi = glsl_expr._tensor(xi, dev).to(torch.int32)
        yi = glsl_expr._tensor(yi, dev).to(torch.int32)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        x = torch.clamp(xi, 0, w - 1).long()
        y = torch.clamp(yi, 0, h - 1).long()
        return tuple(torch.where(inside, p[y, x], 0.0) for p in prev)

    class _Unresolvable(Exception):
        pass

    def _prov_resolved_prev(xi, yi):
        """Structural resolution of a fetch at a provenance-tracked y
        plane: texel(where(m, a, b)) == where(m, texel(a), texel(b))
        pointwise, so the fetch recurses through the masked-merge tree
        down to (a) first-hit walk results: ONE cached fetch per (walk
        signature, x pattern), shared by every fetch site (the latch
        scan when the fetch's columns are the walk's, else the row-wise
        lookup with C = 4), and (b) host-known planes, which are
        static shifts/broadcasts. Bit-exact with fetching the merged
        plane directly."""
        ex = _CURRENT_EXEC
        if ex is None or prev is None or _is_t(xi):
            return None
        if not _is_t(yi) or ex._prov_lookup(yi) is None:
            return None
        px = _col_pattern(xi, h, w)
        if px is None:
            return None

        def leaf_concrete(v):
            py = _row_pattern(np.asarray(v, np.int32), h, w)
            if py is None:
                raise _Unresolvable
            return _shifted_prev(px, py)

        def resolve(v, depth):
            if depth > 24:
                raise _Unresolvable
            if not _is_t(v):
                return leaf_concrete(v)
            node = ex._prov_lookup(v)
            if node is None:
                raise _Unresolvable
            if node["kind"] == "walk":
                key = ("texel", node["sig"], px)
                done = ex.__dict__.setdefault("_prov_texel", {})
                if key in done:
                    return done[key]
                val = None
                lf = node.get("latch")
                if lf is not None and px == node.get("latch_px"):
                    # gather-free: the latch scan carried the boundary
                    # texels through the first-event scan
                    val = lf(px)
                if val is None:
                    val = _col_fetch(px, node["plane"])
                if not ex._loop_stack:
                    done[key] = val
                return val
            a = resolve(node["new"], depth + 1)
            b = resolve(node["old"], depth + 1)
            m = node["mask"]
            return tuple(_where(m, p, q) for p, q in zip(a, b))

        try:
            out = resolve(yi, 0)
        except _Unresolvable:
            return None
        _PROV_HITS[0] += 1
        return out

    def textureSize(tex, _lod=0):
        """ivec2 (screen) for the prev sampler2D, int texel count for
        the 1-D audio textures: host numpy so downstream coordinate
        math stays inspectable."""
        if isinstance(tex, str) and tex == "prev":
            return (np.int32(w), np.int32(h))
        return np.int32(sz)

    def texelFetch(tex, idx, _lod=0):
        if isinstance(tex, str) and tex == "prev":
            if prev is None:
                raise ShaderError("`prev` sampled but this is the first pass")
            if not isinstance(idx, tuple) or len(idx) != 2:
                raise ShaderError("texelFetch on prev needs ivec2")
            shift = _prev_const_shift(idx[0], idx[1])
            if shift is not None:
                return _shifted_prev(*shift)
            wk = _walk_shifted_prev(idx[0], idx[1])
            if wk is not None:
                return wk
            pv = _prov_resolved_prev(idx[0], idx[1])
            if pv is not None:
                return pv
            col = _col_aligned_prev(idx[0], idx[1])
            if col is not None:
                return col
            # out-of-bounds texelFetch reads transparent black (the
            # robust-access behaviour the GL path exhibits)
            return _general_fetch(idx[0], idx[1])
        i1 = (np.asarray(idx, np.int32)
              if isinstance(idx, (np.ndarray, np.generic, int, float))
              else glsl_expr._tensor(idx, dev).to(torch.int32))
        return _rgba(_fetch_1d(tex, i1, sz))

    def ivec2(x, y):
        def conv(v):
            # host-known coordinates stay numpy PER COMPONENT so the
            # fetch routes can inspect them. A registered walk variable
            # or a provenance-tracked plane passes through AS-IS: the
            # routes match it by object identity (int truncation
            # happens inside them, toward zero like the cast).
            if _walk_match(v) is not None:
                return v
            if _is_t(v):
                ex = _CURRENT_EXEC
                if ex is not None and ex._prov_lookup(v) is not None:
                    return v
                return v.to(torch.int32)
            return np.asarray(v, np.int32)

        return (conv(x), conv(y))

    def smooth_audio(tex, _sz, idx):
        # host-known positions stay numpy through the clamp so the
        # sampler can see their structure (a column-constant plane
        # fetches one row and broadcasts)
        if isinstance(idx, (np.ndarray, np.generic, int, float)):
            return smooth_fetch(tex, np.clip(np.asarray(idx), 0.0, 1.0))
        return smooth_fetch(tex, torch.clamp(glsl_expr._tensor(idx, dev),
                                             0.0, 1.0))

    def smooth_audio_adj(tex, _sz, idx, pixel):
        if _np_concrete(idx, pixel):
            a = smooth_audio(tex, _sz, np.maximum(idx - pixel, 0.0))
            b = smooth_audio(tex, _sz, idx)
            c = smooth_audio(tex, _sz, np.minimum(idx + pixel, 1.0))
        else:
            ti, tp = glsl_expr._tensors(idx, pixel)
            a = smooth_audio(tex, _sz, torch.clamp(ti - tp, min=0.0))
            b = smooth_audio(tex, _sz, ti)
            c = smooth_audio(tex, _sz, torch.clamp(ti + tp, max=1.0))
        return (a + b + c) / 3.0

    # screen-space derivatives with GL's 2x2-quad semantics: within
    # each aligned pixel quad both fragments of a pair see the SAME
    # difference (coarse derivatives)
    def _quad_diff(v, axis):
        def one(p):
            p = glsl_expr._tensor(p, dev).to(torch.float32).expand(h, w)
            n = p.shape[axis] - p.shape[axis] % 2
            even = [slice(None)] * 2
            even[axis] = slice(0, n, 2)
            odd = [slice(None)] * 2
            odd[axis] = slice(1, n, 2)
            d = p[tuple(odd)] - p[tuple(even)]
            d = torch.repeat_interleave(d, 2, dim=axis)
            if p.shape[axis] % 2:  # odd edge: replicate last pair diff
                last = [slice(None)] * 2
                last[axis] = slice(-1, None)
                d = torch.cat([d, d[tuple(last)]], dim=axis)
            return d

        if isinstance(v, tuple):
            return tuple(one(c) for c in v)
        return one(v)

    def dFdx(v):
        return _quad_diff(v, 1)

    def dFdy(v):
        return _quad_diff(v, 0)

    def fwidth(v):
        def absadd(a, b):
            return torch.abs(a) + torch.abs(b)

        dx, dy = dFdx(v), dFdy(v)
        if isinstance(v, tuple):
            return tuple(absadd(a, b) for a, b in zip(dx, dy))
        return absadd(dx, dy)

    return {
        "texture": texture,
        "texelFetch": texelFetch,
        "textureLod": lambda tex, x, _lod=0: texture(tex, x),
        "textureSize": textureSize,
        "ivec2": ivec2,
        "smooth_audio": smooth_audio,
        "smooth_audio_adj": smooth_audio_adj,
        "dFdx": dFdx,
        "dFdy": dFdy,
        "fwidth": fwidth,
        "__ext_texels": _ext_texels,
    }

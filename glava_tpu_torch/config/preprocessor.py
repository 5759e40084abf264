"""The GLava config-language preprocessor, evaluated host-side.

Re-implements the directive semantics of glava/glsl_ext.c:346-725 for
configuration purposes:

* ``#request name args...`` — tokenized with double-quote support
  (glsl_ext.c:657-706) and dispatched to the request table.
* ``#include "path"`` — ``:`` prefix resolves against the user config
  root, ``@`` against the system shader root, otherwise the including
  file's directory (glsl_ext.c:160-227). Recursive.
* ``#define NAME VALUE`` — recorded into an ordered, last-wins knob
  environment. The reference rewrites redefinitions into
  ``#undef``+``#define`` so user files override module defaults
  (glsl_ext.c:143-159); last-wins gives the same result. Function-like
  macros (``NAME(``) are skipped exactly as the reference skips them
  (glsl_ext.c:687-689).
* ``#expand MACRO SYMBOL`` — validated against the registered expand
  symbols (render.c's efuncs); it generated unrolled GLSL in the
  reference (glsl_ext.c:301-339) which has no equivalent here (frame
  averaging is natively vectorized), so it is a checked no-op.
* ``#ifdef/#ifndef NAME ... #endif`` — minimal conditional support used
  by include-guarded utility files; other preprocessor conditionals
  pass through untouched (module logic lives in Python rasterizers).

Differentially tested against the reference's own compiled
``glsl_ext.c`` (tests/test_preprocessor_differential.py: request
streams, define environments, abort agreement, color parsing, over
shipped sources + fuzzed directive streams). Deviations from the
reference (each asserted explicitly in the differential suite):

* directives inside ``/* */`` block comments or string literals are
  NOT executed (the reference's line-start scanner executes them — an
  evident parser quirk);
* ``#ifdef/#ifndef`` gate requests/defines here (include-guard
  idiom); the reference passes conditionals through to the GLSL
  compiler, so requests in false branches still execute there;
* ``#undef`` is honored (extension; the reference passes it raw —
  the effective GLSL macro environment is identical).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

DIRECTIVES = ("request", "include", "define", "expand")

# The #expand input symbols the reference registers as efuncs
# (render.c:283-291 EBIND list; shaders/glava/util/average_pass.frag
# uses _AVG_FRAMES).
DEFAULT_EXPAND_SYMBOLS = (
    "_AVG_FRAMES", "_AVG_WINDOW", "_USE_ALPHA", "_PREMULTIPLY_ALPHA",
    "_CHANNELS", "_UNIFORM_LIMIT", "_PRE_SMOOTHED_AUDIO",
)


class PreprocessError(ValueError):
    def __init__(self, fname: str, line: int, msg: str):
        super().__init__(f"[{fname}:{line}] {msg}")
        self.fname = fname
        self.line = line


@dataclass
class Context:
    """Shared state across one preprocessing tree (one entry file)."""

    system_dir: Path | None = None   # '@' root (dd)
    user_dir: Path | None = None     # ':' root (cfd)
    on_request: Callable[[str, list[str], str, int], None] | None = None
    defines: dict[str, str] = field(default_factory=dict)
    # function-like macros (shader preprocessing only): name -> (params, body)
    fn_macros: dict[str, tuple[list[str], str]] = field(default_factory=dict)
    expand_symbols: tuple[str, ...] = DEFAULT_EXPAND_SYMBOLS
    visited: list[str] = field(default_factory=list)  # processed file names


_COMMENT_BLOCK = re.compile(r"/\*.*?\*/", re.S)
_COMMENT_LINE = re.compile(r"//[^\n]*")


def strip_comments(text: str) -> str:
    """Remove comments while preserving line numbering and strings."""
    out: list[str] = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
            continue
        if c == '"':
            in_str = True
            out.append(c)
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            j = text.find("\n", i)
            i = n if j < 0 else j
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            seg = text[i : (n if j < 0 else j + 2)]
            out.append("\n" * seg.count("\n"))
            i = n if j < 0 else j + 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def tokenize_args(rest: str) -> list[str]:
    """Directive argument split with the reference's exact quote
    handling (glsl_ext.c:653-709, differentially pinned): a quote at
    token start opens quoting, the closing quote ends the token (empty
    quoted tokens are dropped — zero-length spans are never copied), a
    quote mid-token stays literal and does NOT toggle quoting, and an
    unterminated quoted token at end of line is dropped."""
    args: list[str] = []
    quoted = False
    arg_start = True
    start = 0
    n = len(rest)
    for i in range(n):
        ch = rest[i]
        if ch in " \t" and not quoted:
            if i > start:
                args.append(rest[start:i])
            arg_start = True
            start = i + 1
        elif ch == '"':
            if quoted:
                if i > start:
                    args.append(rest[start:i])
                quoted = False
                arg_start = True
                start = i + 1
            elif arg_start:
                start = i + 1
                quoted = True
            else:
                arg_start = False  # mid-token quote: literal
        else:
            arg_start = False
    if not quoted and n > start:
        args.append(rest[start:n])
    return args


_DEFINE_RE = re.compile(r"^\s*(\w+)(\(?)\s*(.*?)\s*$", re.S)


def process_text(
    text: str,
    ctx: Context,
    fname: str = "<string>",
    current_dir: Path | None = None,
) -> None:
    ctx.visited.append(fname)
    lines = strip_comments(text).split("\n")

    # Backslash continuations: the reference's directive parser has no
    # continuation handling at all — a '\' on a directive line is a
    # literal token and the next line is parsed normally
    # (differentially pinned). Only #define VALUES effectively join
    # (the emitted raw text keeps '\'+newline and the GLSL compiler
    # joins), so join continuations onto #define lines only, stopping
    # at a continued line that itself starts a directive (the
    # reference's scanner still fires those).
    joined: list[tuple[int, str]] = []
    _DEFINE_LINE = re.compile(r"\s*#\s*(define|DEFINE)\b")
    i = 0
    while i < len(lines):
        ln, line = i + 1, lines[i]
        if _DEFINE_LINE.match(line) and line.endswith("\\"):
            acc = [line[:-1]]
            j = i + 1
            while j < len(lines):
                nxt = lines[j]
                if nxt.lstrip().startswith("#"):
                    break  # the reference fires directives here
                if nxt.endswith("\\"):
                    acc.append(nxt[:-1])
                    j += 1
                    continue
                acc.append(nxt)
                j += 1
                break
            joined.append((ln, " ".join(acc)))
            i = j
            continue
        joined.append((ln, line))
        i += 1

    cond_stack: list[bool] = []  # minimal #ifdef/#ifndef support
    # `:`/`@` includes permanently switch this file's include root for
    # subsequent plain includes (ext->cd mutation, glsl_ext.c:166-180;
    # differentially pinned). Child files inherit the mutated root.
    cur_base = current_dir

    for ln, line in joined:
        stripped = line.lstrip()
        if not stripped.startswith("#"):
            continue
        body = stripped[1:]
        # the reference's directive-name lexer (glsl_ext.c:600-642):
        # [A-Za-z0-9]* (no underscore), not starting with a digit, and
        # '#' followed by whitespace/EOL or any other character is a
        # hard parse error
        m = re.match(r"([A-Za-z][A-Za-z0-9]*)", body)
        if not m:
            nxt = body[0] if body else "\\n"
            raise PreprocessError(
                fname, ln,
                f"Unexpected character '{nxt}' while parsing GLSL "
                "directive")
        word = m.group(1)
        rest = body[m.end():]
        if rest and rest[0] not in " \t":
            # an identifier terminated by a non-name, non-whitespace
            # character ('#a_b', '#x(', '#if(x)') is the same hard
            # error — the reference's lexer knows no exceptions
            raise PreprocessError(
                fname, ln,
                f"Unexpected character '{rest[0]}' while parsing "
                "GLSL directive")
        # directives match all-lower or ALL-UPPER, exactly
        # (glsl_ext.c:607-617 DIRECTIVE_CMP checks both spellings)
        if word.isupper() and word.lower() in DIRECTIVES:
            word = word.lower()
        rest = rest.lstrip()

        if word in ("ifdef", "ifndef"):
            name = rest.strip().split()[0] if rest.strip() else ""
            defined = name in ctx.defines
            cond_stack.append(defined if word == "ifdef" else not defined)
            continue
        if word == "if":
            cond_stack.append(True)  # pass-through conditionals
            continue
        if word in ("else", "elif"):
            if cond_stack:
                cond_stack[-1] = not cond_stack[-1] if word == "else" else False
            continue
        if word == "endif":
            if cond_stack:
                cond_stack.pop()
            continue
        if cond_stack and not all(cond_stack):
            continue
        if word == "undef":
            name = rest.strip().split()[0] if rest.strip() else ""
            ctx.defines.pop(name, None)
            continue
        if word not in DIRECTIVES:
            continue

        if word == "define":
            dm = _DEFINE_RE.match(rest)
            if not dm:
                raise PreprocessError(fname, ln, "No arguments provided to #define directive!")
            name, paren, value = dm.groups()
            if paren == "(":
                # function-like macro: recorded for the shader
                # interpreter's expansion (the reference's own
                # preprocessor leaves these to the GLSL compiler,
                # glsl_ext.c:687-689)
                pm = re.match(r"\(([^)]*)\)\s*(.*)$", "(" + value, re.S)
                if pm:
                    params = [p.strip() for p in pm.group(1).split(",")
                              if p.strip()]
                    ctx.fn_macros[name] = (params, pm.group(2).strip())
                continue
            # the reference's GLSL scan validates hex-color literals as
            # it copies the define value (glsl_ext.c:489-514); fail a
            # knob typo at load time the same way
            from glava_tpu_torch.config.colors import expand_colors

            if expand_colors(value) is None:
                raise PreprocessError(
                    fname, ln,
                    f"Invalid color format while parsing '#define "
                    f"{name} {value}'")
            ctx.defines[name] = value
            continue

        args = tokenize_args(rest)

        if word == "request":
            if not args:
                continue
            if ctx.on_request is None:
                raise PreprocessError(fname, ln, "no request dispatcher in this context")
            ctx.on_request(args[0], args[1:], fname, ln)
            continue

        if word == "include":
            if not args:
                raise PreprocessError(fname, ln, "No arguments provided to #include directive!")
            target = args[0]
            if target.startswith(":"):
                target = target[1:]
                if ctx.user_dir is not None:
                    cur_base = ctx.user_dir  # persists for this file
                elif ctx.system_dir is not None:
                    # No user config root: fall back to the system root
                    # so `:file` includes still resolve (the reference
                    # always passes the install path as cfd when no
                    # user dir exists, glava.c:294-301)
                    cur_base = ctx.system_dir
            elif target.startswith("@"):
                if ctx.system_dir is None:
                    raise PreprocessError(
                        fname, ln,
                        "encountered '@' path specifier while no default "
                        "directory is available in the current context",
                    )
                target = target[1:]
                cur_base = ctx.system_dir  # persists for this file
            if cur_base is None:
                raise PreprocessError(fname, ln, f"cannot resolve include '{args[0]}'")
            path = Path(cur_base) / target
            if not path.is_file() and target.startswith("smooth_parameters"):
                # user root may lack an override; mirror reference layering
                # by falling back to the system copy
                alt = Path(ctx.system_dir or cur_base) / target
                if alt.is_file():
                    path = alt
            if not path.is_file():
                raise PreprocessError(
                    fname, ln,
                    f"failed to load source specified by #include directive '{path}'",
                )
            # the child inherits the (possibly mutated) root — include
            # paths do NOT resolve relative to the included file's own
            # directory (glsl_ext.c:200-214 passes ext->cd unchanged;
            # differentially pinned)
            process_text(path.read_text(), ctx, fname=str(path),
                         current_dir=cur_base)
            continue

        if word == "expand":
            if len(args) < 2:
                raise PreprocessError(
                    fname, ln,
                    f"#expand directive missing arguments, requires 2 identifiers (got {len(args)})",
                )
            if args[1] not in ctx.expand_symbols:
                raise PreprocessError(
                    fname, ln, f'#expand directive specified invalid input "{args[1]}"'
                )
            continue


def process_file(path: str | Path, ctx: Context) -> None:
    path = Path(path)
    process_text(path.read_text(), ctx, fname=str(path), current_dir=path.parent)


# ---------------------------------------------------------------------------
# shader-source preprocessing (for the GLSL subset interpreter)
# ---------------------------------------------------------------------------

class StageDisabledDirective(Exception):
    """`#error __disablestage` — skip this pass (render.c:358-371)."""


class _PPEnv:
    """#if evaluation env: undefined macros read as 0 (C preprocessor
    semantics)."""

    def __init__(self, defines: dict[str, str]):
        from glava_tpu_torch.config import glsl_expr

        self._inner = glsl_expr.Env(defines=dict(defines))
        self.functions = {}
        self.pipe_values = {}
        self.variables = {}
        self.defines = self._inner.defines

    def lookup(self, name: str):
        try:
            return self._inner.lookup(name)
        except Exception:
            return 0.0


def eval_pp_expr(expr: str, defines: dict[str, str]):
    """Evaluate a `#if` expression over the macro environment."""
    from glava_tpu_torch.config import glsl_expr

    expr = re.sub(r"defined\s*\(\s*(\w+)\s*\)",
                  lambda m: "1" if m.group(1) in defines else "0", expr)
    expr = re.sub(r"defined\s+(\w+)",
                  lambda m: "1" if m.group(1) in defines else "0", expr)
    return glsl_expr.evaluate(expr, _PPEnv(defines))


def preprocess_shader_source(
    text: str, ctx: Context, fname: str = "<shader>",
    current_dir: Path | None = None, srcmap: list | None = None,
) -> str:
    """Resolve a pass source for the GLSL interpreter.

    Executes `#request`s`, records `#define`s, fully evaluates
    `#if/#elif/#else/#endif` over the knob environment, processes
    `#include`s for their defines/requests, expands `#expand`
    code generation, honors `#error __disablestage`, and returns the
    active GLSL lines.

    When ``srcmap`` is a list, one ``(origin fname, origin line)``
    entry is appended per OUTPUT line — the ss_lookup-style map
    (glsl_ext.c:358-384) that shader errors use to cite the true
    source location through the include tree.
    """
    out: list[str] = []
    omap: list = []  # (fname, line) per out element's lines
    stack: list[tuple[bool, bool]] = []  # (currently_active, any_taken)

    def active() -> bool:
        return all(a for a, _ in stack)

    for ln, line in enumerate(strip_comments(text).split("\n"), start=1):
        s = line.strip()
        if not s.startswith("#"):
            if active():
                out.append(line)
                omap.append((fname, ln))
            continue
        body = s[1:].lstrip()
        m = re.match(r"([A-Za-z_][A-Za-z0-9_]*)", body)
        word = m.group(1) if m else ""
        rest = body[m.end():].strip() if m else ""

        if word == "ifdef":
            cond = rest.split()[0] in ctx.defines if rest else False
            stack.append((cond, cond))
        elif word == "ifndef":
            cond = rest.split()[0] not in ctx.defines if rest else False
            stack.append((cond, cond))
        elif word == "if":
            try:
                cond = bool(eval_pp_expr(rest, ctx.defines)) if active() else False
            except Exception as e:
                raise PreprocessError(fname, ln, f"cannot evaluate #if {rest}: {e}")
            stack.append((cond, cond))
        elif word == "elif":
            if not stack:
                raise PreprocessError(fname, ln, "#elif without #if")
            was_active, taken = stack.pop()
            if taken:
                stack.append((False, True))
            else:
                try:
                    cond = bool(eval_pp_expr(rest, ctx.defines))
                except Exception as e:
                    raise PreprocessError(fname, ln, f"cannot evaluate #elif: {e}")
                stack.append((cond, cond))
        elif word == "else":
            if not stack:
                raise PreprocessError(fname, ln, "#else without #if")
            was_active, taken = stack.pop()
            stack.append((not taken, True))
        elif word == "endif":
            if stack:
                stack.pop()
        elif not active():
            continue
        elif word == "error":
            if "__disablestage" in rest:
                raise StageDisabledDirective()
            raise PreprocessError(fname, ln, f"#error {rest}")
        elif word == "define":
            dm = _DEFINE_RE.match(body[len("define"):])
            if dm:
                name, paren, value = dm.groups()
                if paren != "(":
                    ctx.defines[name] = value
                else:
                    # function-like macro: NAME(a, b) body
                    pm = re.match(r"\(([^)]*)\)\s*(.*)$", "(" + value, re.S)
                    if pm:
                        params = [p.strip() for p in pm.group(1).split(",")
                                  if p.strip()]
                        ctx.fn_macros[name] = (params, pm.group(2).strip())
        elif word == "undef":
            ctx.defines.pop(rest.split()[0] if rest else "", None)
        elif word == "include":
            args = tokenize_args(rest)
            if args:
                target = args[0]
                base = current_dir
                if target.startswith(":"):
                    target, base = target[1:], ctx.user_dir or ctx.system_dir
                elif target.startswith("@"):
                    target, base = target[1:], ctx.system_dir
                path = Path(base) / target if base else None
                if path is not None and not path.is_file() and ctx.system_dir:
                    alt = Path(ctx.system_dir) / target
                    if alt.is_file():
                        path = alt
                if path is not None and path.is_file():
                    # recursive: defines/requests accumulate on ctx and
                    # the resolved text is inlined (GLSL function
                    # definitions inside are later skipped by the body
                    # parser; their calls bind to interpreter builtins)
                    imap: list = []
                    inlined = preprocess_shader_source(
                        path.read_text(), ctx, fname=str(path),
                        current_dir=path.parent, srcmap=imap,
                    )
                    if inlined.strip():
                        out.append(inlined)
                        omap.extend(imap)
        elif word == "request":
            args = tokenize_args(rest)
            if args and ctx.on_request is not None:
                ctx.on_request(args[0], args[1:], fname, ln)
        elif word == "expand":
            # `#expand MACRO SYMBOL` emits `MACRO(0);` .. `MACRO(N-1);`
            # into the source (glsl_ext.c:301-339, format "%s(%d);\n"),
            # N = the registered efunc's value — here the synthesized
            # builtin define of the same name (render.c:283-291 EBINDs)
            args = tokenize_args(rest)
            if len(args) < 2:
                raise PreprocessError(
                    fname, ln, "#expand directive missing arguments, "
                    f"requires 2 identifiers (got {len(args)})")
            sym = args[1]
            if sym not in ctx.expand_symbols or sym not in ctx.defines:
                raise PreprocessError(
                    fname, ln,
                    f'#expand directive specified invalid input "{sym}"')
            try:
                n = int(float(ctx.defines[sym]))
            except (TypeError, ValueError):
                raise PreprocessError(
                    fname, ln,
                    f'#expand input "{sym}" has no numeric value')
            for t in range(n):
                out.append(f"{args[0]}({t});")
                omap.append((fname, ln))
        # #version / #line / unknown directives: dropped
    result = "\n".join(out)
    if srcmap is not None:
        # one entry per output LINE: single-line appends map 1:1;
        # inlined includes contributed their own (already line-wise)
        # entries above. Macro expansion below never changes the line
        # count (bodies are single-line by the #define grammar).
        srcmap.extend(omap)
    if ctx.fn_macros:
        # object-like defines whose body IS a function-like macro name
        # (e.g. `#define ROUND_FORMULA sinusoidal` then
        # `ROUND_FORMULA(x)`, smooth_parameters.glsl + smooth.glsl) —
        # a C preprocessor expands the object macro first, then the
        # call; register the alias so one pass handles both
        macros = dict(ctx.fn_macros)
        for dname, dval in ctx.defines.items():
            tgt = str(dval).strip()
            if tgt in ctx.fn_macros and dname not in macros:
                macros[dname] = ctx.fn_macros[tgt]
        result = expand_function_macros(result, macros)
    return result


def expand_function_macros(text: str, fn_macros: dict,
                           max_depth: int = 8) -> str:
    """Textual expansion of function-like macros (C-preprocessor style:
    parameters substituted at identifier boundaries, arguments split on
    top-level commas, balanced parentheses)."""
    for _ in range(max_depth):
        changed = False
        for name, (params, mbody) in fn_macros.items():
            pat = re.compile(rf"\b{re.escape(name)}\s*\(")
            pos = 0
            while True:
                m = pat.search(text, pos)
                if not m:
                    break
                # balanced-paren argument scan
                depth, i = 1, m.end()
                args, start = [], m.end()
                while i < len(text) and depth:
                    c = text[i]
                    if c == "(":
                        depth += 1
                    elif c == ")":
                        depth -= 1
                        if depth == 0:
                            args.append(text[start:i])
                    elif c == "," and depth == 1:
                        args.append(text[start:i])
                        start = i + 1
                    i += 1
                if depth:
                    break  # unbalanced; leave as-is
                args = [a.strip() for a in args]
                if len(params) != len([a for a in args if a != ""]) and \
                        not (not params and args == [""]):
                    pos = m.end()
                    continue
                body = mbody
                # `##` token pasting first, with RAW (unparenthesized)
                # arguments, C-preprocessor style — `t##I` with I=3
                # must yield `t3`, not `t(3)`
                # (average_pass.frag:20,41)
                raw = dict(zip(params, args))
                while True:
                    pm = re.search(
                        r"([A-Za-z0-9_]+)\s*##\s*([A-Za-z0-9_]+)", body)
                    if not pm:
                        break
                    lt = raw.get(pm.group(1), pm.group(1))
                    rt = raw.get(pm.group(2), pm.group(2))
                    body = body[:pm.start()] + lt + rt + body[pm.end():]
                # RAW text substitution, exactly like the C
                # preprocessor: arguments are NOT parenthesized and the
                # body is NOT wrapped. This is load-bearing for the
                # reference's UNHYGIENIC window macros —
                # `window(I, _AVG_FRAMES - 1)` must expand so the
                # `- 1` becomes a radian phase shift
                # (`TWOPI*I/_AVG_FRAMES - 1`), the curve the compiled
                # reference exhibits (ops/windows.py module note,
                # tests/test_refdsp_differential.py)
                for p, a in zip(params, args):
                    body = re.sub(rf"\b{re.escape(p)}\b",
                                  lambda _m, a=a: a, body)
                text = text[:m.start()] + body + text[i:]
                pos = m.start() + 1
                changed = True
        if not changed:
            return text
    return text

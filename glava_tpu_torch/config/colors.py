"""Hex color literal parsing (``#RRGGBBAA`` and friends).

Matches ``ext_parse_color`` (glava/glsl_ext.c:88-122): an optional
``0x`` prefix, then up to 8 hex chars consumed in 2-char components
mapped to [0, 1]; missing components keep defaults (r=g=b=0, a=1);
a trailing incomplete component is ignored.
"""

from __future__ import annotations

_HEX = "0123456789abcdefABCDEF"


def parse_color(text: str) -> tuple[float, float, float, float] | None:
    """Return (r, g, b, a) floats in [0, 1], or None if invalid."""
    if text.startswith(("0x", "0X")):
        text = text[2:]
    out = [0.0, 0.0, 0.0, 1.0]
    comp = 0
    i = 0
    text = text[:8]
    for ch in text:
        if ch not in _HEX:
            return None
    while i + 1 < len(text) and comp < 4:
        out[comp] = int(text[i : i + 2], 16) / 255.0
        comp += 1
        i += 2
    return tuple(out)


def expand_colors(text: str) -> str | None:
    """Apply the reference's GLSL-scan hex-color expansion to raw text
    (glsl_ext.c:447-514 COLOR state): ``##`` escapes one literal
    ``#``, up to 8 alnum chars after ``#`` form the literal, each
    expanding to `` vec4(r, g, b, a) `` with %.6f components; an
    invalid literal is a parse error (returns None).  Used to validate
    define values eagerly — the reference aborts config loading on a
    bad color anywhere in GLSL text, and knob typos should fail at
    load, not at first evaluation.  Differentially pinned against the
    compiled ext_parse_color in tests/test_preprocessor_differential.py."""
    out: list[str] = []
    i, n = 0, len(text)
    in_str = esc = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                in_str = False
            i += 1
            continue
        if c == '"':
            in_str = True
            out.append(c)
            i += 1
            continue
        if c == "#":
            if i + 1 < n and text[i + 1] == "#":
                out.append("##")
                i += 2
                continue
            j = i + 1
            while j < n and text[j].isalnum() and j - (i + 1) < 8:
                j += 1
            col = parse_color(text[i + 1:j])
            if col is None:
                return None
            out.append(" vec4(%.6f, %.6f, %.6f, %.6f) " % col)
            i = j
            continue
        out.append(c)
        i += 1
    return "".join(out)

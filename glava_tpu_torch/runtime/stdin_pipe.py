"""Live uniform protocol: ``name = value`` lines on stdin (``--pipe``).

Parity with the reference parser (glava/render.c:1861-2005):

* assignments: ``name = value`` (whitespace-tolerant); a bare value
  with no ``=`` targets the default bind ``_`` (PIPE_DEFAULT,
  render.h:40);
* types (render.c:24-33): int, float, bool (true/TRUE/True/1 ...),
  vec2/3/4 as comma-separated floats, and ``#RRGGBBAA`` colors for
  vec4;
* unknown names and malformed values are reported and skipped.

Values land in a shared dict consumed by the render loop each frame
(traced arguments — no recompilation).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import IO, Any

from glava_tpu_torch.config.colors import parse_color

PIPE_DEFAULT = "_"

VALID_TYPES = ("int", "float", "bool", "vec2", "vec3", "vec4")


@dataclass
class PipeBind:
    name: str
    stype: str  # one of VALID_TYPES

    def default_value(self):
        if self.stype == "bool":
            return 0.0
        if self.stype in ("int", "float"):
            return 0.0
        n = int(self.stype[-1])
        return tuple(0.0 for _ in range(n))


def parse_value(stype: str, text: str):
    """Coerce one value per the reference's type switch."""
    text = text.strip()
    if stype == "bool":
        if text in ("true", "TRUE", "True", "1"):
            return 1.0
        if text in ("false", "FALSE", "False", "0"):
            return 0.0
        raise ValueError(f'Bad format for boolean: "{text}"')
    if stype == "int":
        try:
            return float(int(text, 10))
        except ValueError:
            # strtol semantics: leading digits, else 0
            num = ""
            for ch in text.lstrip():
                if ch.isdigit() or (ch in "+-" and not num):
                    num += ch
                else:
                    break
            return float(int(num)) if num and num not in "+-" else 0.0
    if stype == "float":
        try:
            return float(text)
        except ValueError:
            return 0.0
    n = int(stype[-1])
    if stype == "vec4" and text.startswith("#"):
        c = parse_color(text[1:])
        if c is None:
            raise ValueError(f'Bad format for color string: "{text}"')
        return c
    parts = text.split(",")
    vals = []
    for i in range(n):
        try:
            vals.append(float(parts[i].strip()))
        except (IndexError, ValueError):
            vals.append(0.0)  # sscanf partial-match tolerance
    return tuple(vals)


def parse_line(line: str, binds: dict[str, PipeBind]) -> tuple[str, Any] | None:
    """One protocol line -> (name, value) or None (reported/ignored)."""
    line = line.rstrip("\n").strip()
    if not line:
        return None
    if "=" in line:
        name, _, raw = line.partition("=")
        name = name.strip()
        raw = raw.strip()
    else:
        name, raw = PIPE_DEFAULT, line
    bind = binds.get(name)
    if bind is None and name == PIPE_DEFAULT and "STDIN" in binds:
        # legacy --stdin mode: bare values feed the STDIN uniform
        # (render.c:1884, USE_STDIN header render.c:320-326)
        name, bind = "STDIN", binds["STDIN"]
    if bind is None:
        raise KeyError(f'Variable name not bound: "{name}"')
    return name, parse_value(bind.stype, raw)


class PipeReader:
    """Background stdin reader feeding the shared value dict."""

    def __init__(self, binds: list[PipeBind], stream: IO[str]):
        self.binds = {b.name: b for b in binds}
        self.values: dict[str, Any] = {
            b.name: b.default_value() for b in binds
        }
        self._lock = threading.Lock()
        self._stream = stream
        self._thread: threading.Thread | None = None
        self.eof = False

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return  # idempotent across engine reloads
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stdin-pipe")
        self._thread.start()

    def _run(self) -> None:
        for line in self._stream:
            try:
                parsed = parse_line(line, self.binds)
            except (KeyError, ValueError) as e:
                import sys

                print(e, file=sys.stderr)
                continue
            if parsed:
                with self._lock:
                    self.values[parsed[0]] = parsed[1]
        self.eof = True

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return dict(self.values)

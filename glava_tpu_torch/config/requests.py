"""The ``#request`` handler table — GLava's config schema, re-typed.

One handler per reference entry (glava/render.c:1033-1314), with the
same names, argument format strings and side-effect semantics, but
writing into a :class:`RenderConfig` instead of mutating GL state.
Argument coercion matches the dispatcher at glava/glsl_ext.c:240-285:
``i`` strtol (base auto), ``f`` strtof, ``s`` raw string, ``b`` one of
true/false/t/f/1/0.
"""

from __future__ import annotations

from typing import Callable

from glava_tpu_torch.config.colors import parse_color
from glava_tpu_torch.config.state import RenderConfig


class RequestError(ValueError):
    """Malformed or unknown #request (the reference aborts; we raise)."""


def _parse_bool(raw: str) -> bool:
    if raw == "true":
        return True
    if raw == "false":
        return False
    if len(raw) == 1:
        if raw in "t1":
            return True
        if raw in "f0":
            return False
    raise RequestError(f"tried to parse invalid raw string {raw!r} into a boolean")


def _parse_int(raw: str) -> int:
    """`(int) strtol(raw, NULL, 0)` exactly (glsl_ext.c:250): optional
    whitespace/sign, `0x` hex, leading-`0` OCTAL, else decimal; longest
    valid prefix, 0 on garbage; saturate to long, truncate to int.
    Differentially pinned in tests/test_preprocessor_differential.py."""
    s = raw
    i, n = 0, len(s)
    while i < n and s[i] in " \t\n\r\v\f":
        i += 1
    sign = 1
    if i < n and s[i] in "+-":
        sign = -1 if s[i] == "-" else 1
        i += 1
    if i + 1 < n and s[i] == "0" and s[i + 1] in "xX":
        j = i + 2
        while j < n and s[j] in "0123456789abcdefABCDEF":
            j += 1
        v = int(s[i + 2:j], 16) if j > i + 2 else 0
    elif i < n and s[i] == "0":
        j = i + 1
        while j < n and s[j] in "01234567":
            j += 1
        v = int(s[i:j], 8)
    else:
        j = i
        while j < n and s[j].isdigit():
            j += 1
        if j == i:
            return 0
        v = int(s[i:j])
    v *= sign
    # strtol saturates at long range, then the handler casts to int
    v = max(-(1 << 63), min(v, (1 << 63) - 1))
    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


def _parse_float(raw: str) -> float:
    try:
        return float(raw)
    except ValueError:
        for end in range(len(raw), 0, -1):
            try:
                return float(raw[:end])
            except ValueError:
                continue
        return 0.0


_COERCE = {"b": _parse_bool, "i": _parse_int, "f": _parse_float, "s": str}


def coerce_args(name: str, fmt: str, raw_args: list[str]) -> list:
    if len(raw_args) < len(fmt):
        raise RequestError(
            f"failed to execute request '{name}': expected format '{fmt}'"
        )
    return [_COERCE[c](raw_args[i]) for i, c in enumerate(fmt)]


def _set_opacity(cfg: RenderConfig, mode: str) -> None:
    native = mode == "native"
    cfg.premultiply_alpha = native
    cfg.copy_desktop = mode == "xroot"
    if not native and mode not in ("xroot", "none"):
        raise RequestError(f"Invalid opacity option: '{mode}'")
    cfg.opacity = mode


def _set_str(attr: str):
    def setter(cfg: RenderConfig, value: str) -> None:
        setattr(cfg, attr, value)

    return setter


def _set_color(attr: str):
    def handler(cfg: RenderConfig, raw: str) -> None:
        c = parse_color(raw)
        if c is None:
            raise RequestError(f"Invalid color value: '{raw}'")
        setattr(cfg, attr, c)

    return handler


def _set_mod(cfg: RenderConfig, name: str) -> None:
    # Honored only while the entry file loads (render.c:1102).
    if cfg.loading_module:
        cfg.module = name


def _smooth_guard(attr: str, conv=None):
    """Knobs ignored while the smooth-pass operator itself is loading
    (`loading_smooth_pass` guard, render.c:1186-1215)."""

    def handler(cfg: RenderConfig, value) -> None:
        if not cfg.loading_smooth_pass:
            setattr(cfg, attr, conv(value) if conv else value)

    return handler


def _set(attr: str, conv=None):
    def handler(cfg: RenderConfig, value) -> None:
        setattr(cfg, attr, conv(value) if conv else value)

    return handler


def _add_xwinstate(cfg: RenderConfig, state: str) -> None:
    # In --desktop mode user xwinstates are dropped unless the env
    # preset file is the one loading (render.c:1143-1147).
    if not cfg.auto_desktop or cfg.loading_presets:
        cfg.xwinstates.append(state)


def _set_geometry(cfg: RenderConfig, x: int, y: int, w: int, h: int) -> None:
    cfg.geometry = (x, y, w, h)


def _set_version(cfg: RenderConfig, major: int, minor: int) -> None:
    cfg.context_version = (major, minor)


def _set_bgf(cfg: RenderConfig, r: float, g: float, b: float, a: float) -> None:
    cfg.clear_color = (r, g, b, a)


def _nativeonly(cfg: RenderConfig, value: bool) -> None:
    # Deprecated in the reference (render.c:1111-1122); accepted, unused.
    pass


# name -> (fmt, handler). Parity list: render.c:1033-1314.
HANDLERS: dict[str, tuple[str, Callable]] = {
    "setopacity":          ("s", _set_opacity),
    "setmirror":           ("b", _set("mirror_input")),
    "setfullscreencheck":  ("b", _set("fullscreen_check")),
    "setbg":               ("s", _set_color("clear_color")),
    "settesteval":         ("s", _set_color("test_eval_color")),
    "setbgf":              ("ffff", _set_bgf),
    # extension (no reference analogue): wallpaper image used as the
    # xroot-opacity composite source in place of the X root pixmap
    "setbgimg":            ("s", _set_str("background_image")),
    "mod":                 ("s", _set_mod),
    "nativeonly":          ("b", _nativeonly),
    "setfloating":         ("b", _set("floating")),
    "setdecorated":        ("b", _set("decorated")),
    "setfocused":          ("b", _set("focused")),
    "setmaximized":        ("b", _set("maximized")),
    "setversion":          ("ii", _set_version),
    "setgeometry":         ("iiii", _set_geometry),
    "addxwinstate":        ("s", _add_xwinstate),
    "setsource":           ("s", _set("audio_source")),
    "setclickthrough":     ("b", _set("clickthrough")),
    "setforcegeometry":    ("b", _set("force_geometry")),
    "setforceraised":      ("b", _set("force_raised")),
    "setxwintype":         ("s", _set("xwintype")),
    "setshaderversion":    ("i", _set("shader_version")),
    "setswap":             ("i", _set("swap")),
    "setframerate":        ("i", _set("framerate")),
    "setprintframes":      ("b", _set("print_frames")),
    "settitle":            ("s", _set("title")),
    "setbufsize":          ("i", _set("bufsize")),
    "setbufscale":         ("i", _set("bufscale")),
    "setsamplerate":       ("i", _set("sample_rate")),
    "setsamplesize":       ("i", _set("samplesize")),
    "setaccelfft":         ("b", _set("accel_fft")),
    "setavgframes":        ("i", _smooth_guard("avg_frames")),
    "setavgwindow":        ("b", _smooth_guard("avg_window")),
    "setgravitystep":      ("f", _smooth_guard("gravity_step")),
    "setsmoothpass":       ("b", _smooth_guard("smooth_pass")),
    "setsmoothfactor":     ("f", _smooth_guard("smooth_factor")),
    "setsmooth":           ("f", _smooth_guard("smooth_distance")),
    "setsmoothratio":      ("f", _smooth_guard("smooth_ratio")),
    "setinterpolate":      ("b", _smooth_guard("interpolate")),
    "setfftscale":         ("f", _smooth_guard("fft_scale")),
    "setfftcutoff":        ("f", _smooth_guard("fft_cutoff")),
    "timecycle":           ("f", _set("timecycle")),
    # `transform` and `uniform` need module-pass context; the module
    # loader installs these (glava_tpu/config/modules.py) the same way
    # rd_new scopes them to the current stage (render.c:1218-1312).
}


def execute(cfg: RenderConfig, name: str, raw_args: list[str],
            extra: dict[str, Callable] | None = None) -> None:
    """Dispatch one request (glsl_ext.c:228-300 REQUEST case)."""
    if extra and name in extra:
        extra[name](cfg, raw_args)
        return
    entry = HANDLERS.get(name)
    if entry is None:
        raise RequestError(f"unknown request type '{name}'")
    fmt, fn = entry
    fn(cfg, *coerce_args(name, fmt, raw_args))

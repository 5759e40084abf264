"""Built-in visualizer modules (reference: shaders/glava/<name>/):
bars, radial, circle, wave, graph and test, as in the JAX package.
User GLSL shader directories (``<user_dir>/<name>/1.frag``) run through
the interpreter (``glsl_module``), and user Python modules
(``<user_dir>/modules/<name>.py``, :func:`load_user_modules`) register
through :func:`register`; the config loader captures both into its own
override map, which takes precedence over this registry."""

from __future__ import annotations

import ast
import importlib.util
from pathlib import Path
from typing import Callable

from glava_tpu_torch.render.base import ModuleBuild, ModuleContext

_STEREO_FFT = (
    ("audio_l", "audio_l", ("window", "fft", "gravity", "avg")),
    ("audio_r", "audio_r", ("window", "fft", "gravity", "avg")),
)

# module -> (builder, uniform declarations (name, source, transforms))
# mirroring each module's `#request uniform`/`#request transform` lines.
_REGISTRY: dict[str, tuple[Callable[[ModuleContext], ModuleBuild], tuple]] = {}


def register(name: str, uniforms: tuple = _STEREO_FFT):
    def deco(fn):
        _REGISTRY[name] = (fn, uniforms)
        return fn

    return deco


def _resolve(name: str, overrides: dict | None = None):
    if overrides and name in overrides:
        return overrides[name]
    if name in _REGISTRY:
        return _REGISTRY[name]
    avail = sorted(set(_REGISTRY) | set(overrides or ()))
    raise KeyError(f"module '{name}' does not exist (available: {avail})")


def build_module(name: str, ctx: ModuleContext,
                 overrides: dict | None = None) -> ModuleBuild:
    builder, _ = _resolve(name, overrides)
    return builder(ctx)


def _jax_imports(path: Path) -> list[str]:
    """The modules of the JAX package (``jax``, ``glava_tpu``) that the
    Python file at ``path`` imports, read from its syntax tree."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return sorted({n for n in names
                   if n.split(".")[0] in ("jax", "jaxlib", "glava_tpu")})


def load_user_modules(user_dir) -> list[str]:
    """Discover user Python modules: ``<user_dir>/modules/<name>.py``,
    as the JAX package's ``load_user_modules`` does.

    The extensibility story of the reference's module system (users
    drop shader directories into their config root,
    render.c:1488-1597): a user module is a Python file calling
    :func:`register`, with knobs still coming from an optional
    ``<name>.glsl`` next to it. A file that imports ``jax`` or
    ``glava_tpu`` is a JAX program (the JAX package's modules): it is
    refused with ``ValueError``, naming it, before any file runs.
    Returns the names loaded.
    """
    if user_dir is None:
        return []
    mdir = Path(user_dir) / "modules"
    if not mdir.is_dir():
        return []
    files = sorted(mdir.glob("*.py"))
    for py in files:
        jax_mods = _jax_imports(py)
        if jax_mods:
            raise ValueError(
                f"user module '{py}' imports {', '.join(jax_mods)}: it is "
                "written for the JAX package; a module of this package "
                "registers through glava_tpu_torch.render.modules.register "
                "(see glava_tpu_torch/examples/vu_meter.py)")
    loaded = []
    for py in files:
        before = set(_REGISTRY)
        spec = importlib.util.spec_from_file_location(
            f"glava_tpu_torch_user_module_{py.stem}", py)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        loaded.extend(sorted(set(_REGISTRY) - before))
    return loaded


def available() -> list[str]:
    """The built-in modules' names."""
    return sorted(_REGISTRY)


def module_uniforms(name: str, overrides: dict | None = None) -> tuple:
    """Uniform declarations for a module's audio pipeline."""
    return _resolve(name, overrides)[1]


# import for registration side effects
from glava_tpu_torch.render.modules import (  # noqa: E402,F401
    bars,
    circle,
    graph,
    radial,
    test,
    wave,
)

"""Built-in visualizer modules (reference: shaders/glava/<name>/):
bars, radial, circle, wave, graph and test, as in the JAX package.
User GLSL shader directories (``<user_dir>/<name>/1.frag``) run through
the interpreter (``glsl_module``); the config loader registers them in
its own override map, which takes precedence over this registry. User
Python module files are JAX programs, and the loader refuses them."""

from __future__ import annotations

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

"""Built-in visualizer modules (reference: shaders/glava/<name>/):
bars, radial, circle, wave, graph and test, as in the JAX package.
User modules (GLSL shader directories, Python module files) need the
interpreter, ROADMAP slice 3; the loader refuses them."""

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


def _resolve(name: str):
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"module '{name}' does not exist "
                   f"(available: {sorted(_REGISTRY)})")


def build_module(name: str, ctx: ModuleContext) -> ModuleBuild:
    builder, _ = _resolve(name)
    return builder(ctx)


def module_uniforms(name: str) -> tuple:
    """Uniform declarations for a module's audio pipeline."""
    return _resolve(name)[1]


# import for registration side effects
from glava_tpu_torch.render.modules import (  # noqa: E402,F401
    bars,
    circle,
    graph,
    radial,
    test,
    wave,
)

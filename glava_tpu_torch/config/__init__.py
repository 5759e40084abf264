"""Configuration engine: GLava's shader-as-config surface, evaluated
into a :class:`~glava_tpu_torch.config.state.RenderConfig` plus the knob
environment the torch rasterizers read."""

from glava_tpu_torch.config.state import RenderConfig  # noqa: F401

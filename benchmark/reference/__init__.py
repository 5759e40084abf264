"""The plain reference the benchmark judges the program's frames by.

Plain numpy and torch, importing nothing of the program: ``dsp`` is the
accel-path update (window, packed FFT, log-magnitude and boost, GL_R16
clamps, gravity, the age-weighted average) and the default smooth pass,
after ``tests/oracles.py``'s transcription of GLava's ``render.c``; one
file a module (``bars``, ``radial``, ``circle``, ``wave``) rasterizes
its frame from the textures, after GLava's shipped ``<module>/*.frag``
as the port's plain-torch modules re-express them. A module is found by
its name: a later configuration with another module adds its file.
"""

import importlib


def module(name: str):
    """The reference raster of module ``name`` (``reference/<name>.py``)."""
    if not name.isidentifier():
        raise ValueError(f"no reference module named {name!r}")
    return importlib.import_module(f"reference.{name}")


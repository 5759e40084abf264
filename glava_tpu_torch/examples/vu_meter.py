"""Example user module: a stereo VU meter, for the PyTorch port.

The torch transcription of the JAX package's docs/examples/vu_meter.py.
Install into your config root and select it:

    mkdir -p ~/.config/glava_tpu/modules
    cp glava_tpu_torch/examples/vu_meter.py ~/.config/glava_tpu/modules/
    glava-tpu-torch -m vu_meter

Optionally create ~/.config/glava_tpu/vu_meter.glsl with knob
overrides:

    #define METER_COLOR #22cc44
    #define PEAK_COLOR  #cc2222
    #define AMPLIFY 400

A module registers a builder producing pass functions over (H, W, 4)
float RGBA frames (row 0 at the bottom) or channel planes; spectrum
textures arrive per declared uniform. A module that reads
``ctx.rows`` and sets ``banded`` renders only its band of rows on a
mesh's rows axis; one that does not renders the whole frame there. See
glava_tpu_torch/render/modules/bars.py for the full pattern.

The module runs inside the compiled step (a CUDA graph a branch, as the
JAX package jits it): its passes are captured once and replayed every
frame. So a pass reaches per-frame values only through its
``PassInputs`` (textures, time, pipe values); Python state the module
changes from call to call is frozen at the capture, as JAX freezes it
at the trace. A pass may not read a tensor on the host (``.item()``,
``.cpu()``, ``.to("cpu")``, ``.numpy()``, ``.tolist()``, ``bool()``,
``float()``, ``print``) nor
make a tensor from host data (``torch.tensor``, ``as_tensor``,
``from_numpy``): the step raises ``compiled.Uncapturable`` naming the
module. The build function below runs once, at load, and may do both;
a host constant a pass needs goes through ``compiled.const`` (uploaded
once).
"""

import numpy as np
import torch

from glava_tpu_torch.config import glsl_expr
from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register


@register(
    "vu_meter",
    uniforms=(
        ("audio_l", "audio_l", ("window", "fft", "gravity", "avg")),
        ("audio_r", "audio_r", ("window", "fft", "gravity", "avg")),
    ),
)
def build(ctx: base.ModuleContext) -> base.ModuleBuild:
    w, h = ctx.screen
    dev = ctx.device
    amplify = ctx.knob_f("AMPLIFY", 400)
    meter = glsl_expr.to_rgba(
        ctx.color_fn("METER_COLOR")() if "METER_COLOR" in ctx.env.defines
        else (0.13, 0.8, 0.27, 1.0)
    ).to(dev)
    peak = glsl_expr.to_rgba(
        ctx.color_fn("PEAK_COLOR")() if "PEAK_COLOR" in ctx.env.defines
        else (0.8, 0.13, 0.13, 1.0)
    ).to(dev)

    # sample a broad band of the smoothed spectrum per channel
    positions = np.linspace(0.05, 0.95, 32)
    sample = ctx.sampler(positions)
    # the rows of this module's band (the whole frame unless ctx.rows)
    _, y = base.frag_coords(w, h, pixel_center_integer=False, rows=ctx.rows)
    rows = torch.as_tensor(y.astype(np.float32), device=dev)[:, None]
    left_half = torch.arange(w, device=dev)[None, :] < (w // 2)

    def pass1(inputs: base.PassInputs) -> torch.Tensor:
        level_l = torch.mean(sample(inputs.textures["audio_l"])) * amplify
        level_r = torch.mean(sample(inputs.textures["audio_r"])) * amplify
        level = torch.where(left_half, level_l, level_r)     # (1, W)
        lit = rows < level
        hot = rows > (0.8 * level)
        return torch.where((lit & hot)[..., None], peak,
                           torch.where(lit[..., None], meter, 0.0))

    return base.ModuleBuild("vu_meter", [pass1], banded=True)

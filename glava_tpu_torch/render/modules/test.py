"""`test` module: the golden-frame CI fixture.

Mirrors shaders/glava/test/{1,2,3}.frag: pass 1 samples both audio
textures (so the whole update runs) and emits the constant
``vec4(1, 0, 0, 1/3)``; pass 2 passes the frame through (prev
chaining); pass 3 is the premultiply include. With ``settesteval
55000055`` (test_rc.glsl) ``--run-tests`` asserts every output pixel
equals the premultiplied constant within +-0.5/255 (render.c:2419-2453).
The module is batched (``ModuleBuild.batched``): textures (S, sz) in,
(S, 1, 1) planes out, the same for any band of rows.
"""

from __future__ import annotations

import torch

from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register


@register("test")
def build(ctx: base.ModuleContext) -> base.ModuleBuild:
    def pass1(inputs: base.PassInputs) -> base.Planes:
        # touch both textures like test/1.frag's dummy smooth_audio
        # calls: (S, 1, 1), one a stream
        tl = inputs.textures["audio_l"]
        tr = inputs.textures["audio_r"]
        dummy = ((torch.sum(tl, dim=-1) + torch.sum(tr, dim=-1)) * 0.0)[:, None, None]
        return tuple(dummy + c for c in (1.0, 0.0, 0.0, 1.0 / 3.0))

    def pass2(inputs: base.PassInputs) -> base.Planes:
        return inputs.prev  # test/2.frag: texelFetch pass-through

    passes = [pass1, pass2]
    if ctx.cfg.premultiply_alpha:
        passes.append(base.premultiply_pass)  # test/3.frag
    return base.ModuleBuild("test", passes, batched=True, banded=True,
                            kind="native")

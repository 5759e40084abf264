"""`bars` module: split-center stereo bar spectrum.

Pixel-for-pixel re-expression of shaders/glava/bars/1.frag (plus the
premultiply pass bars/2.frag, gated on USE_ALPHA). Every column-only
quantity (bar index, section position, sample position, which channel)
is precomputed host-side in numpy, as in the JAX package — per frame
the pass is one spectrum gather per channel and one raster launch
(``ops/raster.py``, the CUDA kernel on the card) for every stream.

The module is batched (``ModuleBuild.batched``): textures (S, sz) in,
(S, H, W) planes out. The COLOR / BAR_OUTLINE knobs depend only on the
row (``d``) and on the ``@fg``/``@bg`` pipe values, so each stream's
colours are one (H, 4) table, evaluated on the device from the step's
pipe inputs (``base.StreamColors``).

Built for a band of rows (``ModuleContext.rows``), the row tables are
the band's; under MIRROR_YX the frame's rows are the pre-transpose
columns, so the band slices the column quantities instead.

Knobs (shaders/glava/bars.glsl): BAR_WIDTH, BAR_GAP, BAR_OUTLINE_WIDTH,
AMPLIFY, GRADIENT, COLOR, BAR_OUTLINE, DIRECTION, INVERT, FLIP,
MIRROR_YX, DISABLE_MONO, USE_ALPHA.
"""

from __future__ import annotations

import numpy as np
import torch

from glava_tpu_torch.ops import raster
from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register


@register("bars")
def build(ctx: base.ModuleContext) -> base.ModuleBuild:
    w, h = ctx.screen
    dev = ctx.device
    mirror_yx = ctx.knob_i("MIRROR_YX", 0) == 1
    aw, ah = (h, w) if mirror_yx else (w, h)

    bw = ctx.knob_f("BAR_WIDTH", 5)
    gap = ctx.knob_f("BAR_GAP", 1)
    bow = ctx.knob_f("BAR_OUTLINE_WIDTH", 1)
    amplify = ctx.knob_f("AMPLIFY", 300)
    direction = ctx.knob_i("DIRECTION", 0)
    invert = ctx.knob_i("INVERT", 0) == 1
    flip = ctx.knob_i("FLIP", 0) == 1
    disable_mono = ctx.knob_i("DISABLE_MONO", 0) == 1
    use_alpha = ctx.knob_i("USE_ALPHA", 0) == 1
    channels = 2 if (disable_mono or ctx.channels == 2) else 1

    # ---- column-only math (bars/1.frag:50-111), host-side -------------
    # the band's rows: rows of the raster, or its columns under MIRROR_YX
    ax, ay = base.frag_coords(aw, ah, pixel_center_integer=False,
                              rows=None if mirror_yx else ctx.rows)
    r0, r1 = ctx.band
    cols = slice(r0, r1) if mirror_yx else slice(None)
    if channels == 2:
        dx = ax - (aw // 2)             # GLSL int division screen.x / 2
    elif invert:
        dx = aw - ax
    else:
        dx = ax.copy()

    section = bw + gap
    center = section / 2.0
    m = np.abs(dx - section * np.floor(dx / section))   # GLSL mod()
    md = m - center
    in_bar = (md < np.ceil(bw / 2.0)) & (md >= -np.floor(bw / 2.0))
    inner = (md < np.ceil(bw / 2.0) - bow) & (md >= -np.floor(bw / 2.0) + bow)

    nbars = np.floor((aw * 0.5) / section) * 2.0
    s = dx / section
    p = np.where(s > 0, np.ceil(s), np.floor(s))
    p = p / (nbars / 2.0 if channels == 2 else nbars)
    p = p + np.sign(p) * ((0.5 + center) / aw)
    oob = (p > 1.0) | (p < -1.0)

    pos = np.abs(p)
    if direction == 1:
        pos = 1.0 - pos
    if channels == 1:
        use_right = np.zeros(aw, dtype=bool)
    elif invert:
        use_right = p <= 0                      # else-branch samples audio_r
    else:
        use_right = p > 0
    visible = in_bar & ~oob

    # sampled at every column, then cut: the resample's sums keep the
    # whole frame's order
    sample = ctx.sampler(np.clip(pos, 0.0, 1.0))
    use_right_t = torch.as_tensor(use_right[cols], device=dev)
    visible_t = torch.as_tensor(visible[cols], device=dev)
    inner_t = torch.as_tensor((inner & visible)[cols], device=dev)

    # ---- row-only quantities -------------------------------------------
    d = ((ah - ay) if flip else ay).astype(np.float32)  # from the baseline
    d_t = torch.as_tensor(d, device=dev)

    def tables(c):
        """COLOR, BAR_OUTLINE -> (S or 1, rows of d, 4) colour tables."""
        return tuple(
            torch.stack([p.expand(p.shape[0], len(d), 1)[..., 0] for p in c[k]],
                        dim=-1).contiguous()
            for k in ("COLOR", "BAR_OUTLINE"))

    colors = base.StreamColors(ctx, ("COLOR", "BAR_OUTLINE"), derive=tables,
                               d=torch.as_tensor(d)[:, None])

    def pass1(inputs: base.PassInputs) -> base.Planes:
        vl = sample(inputs.textures["audio_l"])[..., cols]   # (S, AW)
        vr = sample(inputs.textures["audio_r"])[..., cols]
        v = torch.where(use_right_t, vr, vl) * amplify
        v = torch.where(visible_t, v, -torch.inf)  # gap/oob columns never draw
        color, outline = colors(inputs.pipe)
        # the three outline/body cases of bars/1.frag (only the body
        # without an outline), one launch for every stream
        planes = raster.bars_raster(v.contiguous(), inner_t, d_t, color,
                                    outline, bow, bow > 0)   # (S, 4, AH, AW)
        if mirror_yx:
            planes = planes.transpose(-1, -2)
        return tuple(planes[:, c] for c in range(4))

    passes = [pass1]
    # bars/2.frag: premultiply, compiled only when USE_ALPHA == 1
    if use_alpha and ctx.cfg.premultiply_alpha:
        passes.append(base.premultiply_pass)
    return base.ModuleBuild("bars", passes, batched=True, banded=True,
                            kind="native")

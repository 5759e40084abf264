"""`circle` module: radial amplitude ring.

Re-expression of shaders/glava/circle/{1,2,3}.frag as the JAX
module's fused scalar chain: pass 1 draws a ring displaced by the
smoothed spectrum with slope filling, pass 2 (C_SMOOTH with alpha) is
the neighbourhood smoothing post-effect and pass 3 premultiplies.
Every one of them is the CONSTANT outline colour times one scalar
field, so the chain runs on one (H, W) plane and only the final RGBA
materializes.

The module is batched (``ModuleBuild.batched``): textures (S, sz) in,
(S, H, W) planes out. Per frame the three per-pixel ``smooth_audio``
fetches (circle/1.frag:29-33) of every stream are ONE table lookup:
the static index planes ``round(clip(pos, 0, 1) * sz)`` + ``sz * (not
left)`` of the three sample sites, stacked (3, H, W), into the (S,
2 * sz) tables ``cat([tl, tr])`` (presmoothed first when the smooth
pass is off). On CUDA tensors that is the hand-written lookup kernel
(``ops/lookup.py``), one launch a frame for every stream. OUTLINE, the
module's one colour, is evaluated once at build time, as in the JAX
module, and keeps the load's ``@fg`` value. Built for a band of rows,
the index planes cover the band, widened by one row on each side when
the C_SMOOTH neighbourhood reads its neighbours.

Knobs (shaders/glava/circle.glsl): C_RADIUS, C_LINE, OUTLINE, AMPLIFY,
ROTATE, INVERT, C_FILL, C_SMOOTH.
"""

from __future__ import annotations

import numpy as np
import torch

from glava_tpu_torch.ops import smoothing
from glava_tpu_torch.ops.lookup import StaticLookup
from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register
from glava_tpu_torch.render.modules.wave import crop_rows, neighbor_sum

TWOPI = 6.28318530718
PI = 3.14159265359


def _position(theta: np.ndarray, rotate: float, invert: int):
    """apply_smooth position math (circle/1.frag:34-42)."""
    idx = theta + rotate
    dirv = np.abs(idx) - TWOPI * np.floor(np.abs(idx) / TWOPI)
    idx = np.where(dirv > PI, -np.sign(idx) * (TWOPI - dirv), idx)
    if invert > 0:
        idx = -idx
    pos = np.abs(idx) / (PI + 0.001)
    return pos, idx > 0


def texel_index(pos: np.ndarray, sz: int) -> np.ndarray:
    """The smooth-pass texel fetch index ``round(pos * sz)`` (f32
    multiply, round half to even), clipped into the texture
    (smooth.glsl:61-63)."""
    p32 = np.clip(pos, 0.0, 1.0).astype(np.float32)
    return np.clip(np.round(p32 * np.float32(sz)), 0, sz - 1).astype(np.int64)


@register("circle")
def build(ctx: base.ModuleContext) -> base.ModuleBuild:
    w, h = ctx.screen
    dev = ctx.device
    sz = ctx.sz
    c_radius = ctx.knob_f("C_RADIUS", 128)
    c_line = ctx.knob_f("C_LINE", 1.5)
    amplify = ctx.knob_f("AMPLIFY", 150)
    rotate = ctx.knob_f("ROTATE", PI / 2)
    invert = ctx.knob_i("INVERT", 0)
    c_fill = ctx.knob_i("C_FILL", 0)
    c_smooth = ctx.knob_i("C_SMOOTH", 1)
    use_alpha = ctx.knob_i("_USE_ALPHA", 1) > 0
    outline = base.color_planes(ctx.color_fn("OUTLINE")(), dev)
    smooth_on = c_smooth > 0 and use_alpha

    # static polar geometry; pixel_center_integer (circle/1.frag:1); over
    # the band and the rows the smoothing reads beyond it
    r0, r1 = ctx.band
    a0, a1 = ctx.widened(1) if smooth_on else (r0, r1)
    halo = (r0 - a0, a1 - r1)
    x, y = base.frag_coords(w, h, pixel_center_integer=True, rows=(a0, a1))
    dx = x[None, :] - (w // 2)
    dy = y[:, None] - (h // 2)
    theta = np.arctan2(dy, dx)
    dist = np.sqrt(dx * dx + dy * dy)
    # the center pixel (dist 0) is masked out below (d0 < -C_LINE/2);
    # give it a finite adv so the position math stays NaN-free
    with np.errstate(divide="ignore"):
        adv = np.where(dist > 0, (c_line * 0.5) / np.maximum(dist, 1e-6), 0.0)

    # sites: the pixel's own angle and +-adv along the ring
    planes = []
    for th in (theta, theta + adv, theta - adv):
        pos, left = _position(th, rotate, invert)
        planes.append(texel_index(pos, sz) + np.where(left, 0, sz))
    lookup = StaticLookup(np.stack(planes), 2 * sz, dev)
    presmooth = (None if ctx.cfg.smooth_pass
                 else smoothing.presmooth_op(sz, ctx.smooth_params).on(dev))

    d0 = dist - c_radius
    d0_t = torch.as_tensor(d0.astype(np.float32), device=dev)
    active_t = torch.as_tensor(d0 >= -(c_line / 2.0), device=dev)

    def draw_mask(textures) -> torch.Tensor:
        """The (S, H, W) bool draw predicate of circle/1.frag:44-66."""
        tl, tr = textures["audio_l"], textures["audio_r"]
        if presmooth is not None:
            tl, tr = presmooth(tl), presmooth(tr)
        v, vp, vm = (lookup(torch.cat([tl, tr], dim=-1)) * amplify).unbind(-3)
        a0 = vp - v
        a1 = vm - v
        dmax = torch.maximum(a0, a1)
        dmin = torch.minimum(a0, a1)
        d = d0_t - v
        if c_fill > 0:
            bounds = d < (c_line / 2.0)
        else:
            bounds = ((d > -(c_line / 2.0)) & (d < (c_line / 2.0))) | (
                (d <= dmax) & (d >= dmin))
        return active_t & bounds

    premult_on = bool(ctx.cfg.premultiply_alpha)
    # inter-pass stage FBOs clamp to [0, 1]; fold the clamp into the
    # static colour once
    o_cl = [float(c) for c in np.clip(np.asarray(outline, np.float32), 0.0, 1.0)]

    def pass_fused(inputs: base.PassInputs) -> base.Planes:
        m = draw_mask(inputs.textures).to(torch.float32)
        coef = m
        if smooth_on:
            # circle/2.frag fills pixels whose alpha is 0 with the
            # neighbourhood average; with a zero-alpha outline every
            # pixel qualifies
            wsum = neighbor_sum(m, halo)
            m = crop_rows(m, halo)
            coef = wsum if o_cl[3] == 0.0 else torch.where(m > 0, 1.0, wsum)
        if premult_on:
            a = o_cl[3] * coef
            return ((o_cl[0] * coef) * a, (o_cl[1] * coef) * a,
                    (o_cl[2] * coef) * a, a)
        return tuple(o_cl[c] * coef for c in range(4))

    return base.ModuleBuild("circle", [pass_fused], [lookup], batched=True,
                            banded=True, kind="native")

"""`radial` module: bar spectrum around a circle.

Re-expression of shaders/glava/radial/1.frag (in-shader alpha
anti-aliasing via the APPLY_FRAG blend, radial/1.frag:34-39) plus the
premultiply pass radial/2.frag. The per-pixel polar math is static, so
bar ids, in-bar masks and alias factors bake to numpy constants. Pipe
values reach the knobs as in the JAX module: COLOR and BAR_OUTLINE,
which it evaluates inside the pass (at the static distance ``d``), take
each stream's ``@fg``/``@bg`` values, evaluated on the device from the
step's pipe inputs, with the planes made from them
(``base.StreamColors``); OUTLINE is evaluated once at build time and
keeps the load's values.

The module is batched (``ModuleBuild.batched``). Per frame: one
(NBARS/2 + 1,) spectrum sample per channel and stream, then the
per-pixel bar value ``v`` from ONE table lookup at a static combined
id plane (left ids first, right ids offset by NBARS/2 + 1) into the
(S, 2 * (NBARS/2 + 1)) tables ``cat([vl, vr]) * AMPLIFY`` — on CUDA
tensors the hand-written lookup kernel (``ops/lookup.py``), one launch
a frame for every stream; bit for bit the JAX form
``where(use_left, vl[bar_id], vr[bar_id]) * AMPLIFY``.

Knobs (shaders/glava/radial.glsl): C_RADIUS, C_LINE, OUTLINE, NBARS,
BAR_WIDTH, AMPLIFY, GRADIENT, COLOR, ROTATE, INVERT, BAR_ALIAS_FACTOR,
C_ALIAS_FACTOR, CENTER_OFFSET_X/Y, BAR_OUTLINE, BAR_OUTLINE_WIDTH.
"""

from __future__ import annotations

import numpy as np
import torch

from glava_tpu_torch.ops.lookup import StaticLookup
from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register

TWOPI = 6.28318530718
PI = 3.14159265359


def _apply_frag(f, c, use_alpha: bool):
    """APPLY_FRAG (radial/1.frag:35): alpha blend channel planes c over
    premultiplied channel planes f."""
    if not use_alpha:
        return tuple(c)
    fa = torch.clamp(f[3], 0.0, 1.0)
    rgb = [f[k] * f[3] + c[k] * (1.0 - fa) for k in range(3)]
    return (*rgb, torch.maximum(c[3], f[3]))


@register("radial")
def build(ctx: base.ModuleContext) -> base.ModuleBuild:
    w, h = ctx.screen
    dev = ctx.device
    c_radius = ctx.knob_f("C_RADIUS", 128)
    c_line = ctx.knob_f("C_LINE", 2)
    nbars = ctx.knob_i("NBARS", 160)
    bar_width = ctx.knob_f("BAR_WIDTH", 4.5)
    amplify = ctx.knob_f("AMPLIFY", 300)
    rotate = ctx.knob_f("ROTATE", PI / 2)
    invert = ctx.knob_i("INVERT", 0)
    bar_alias = ctx.knob_f("BAR_ALIAS_FACTOR", 1.2)
    c_alias = ctx.knob_f("C_ALIAS_FACTOR", 1.8)
    off_x = ctx.knob_f("CENTER_OFFSET_X", 0)
    off_y = ctx.knob_f("CENTER_OFFSET_Y", 0)
    bow = ctx.knob_f("BAR_OUTLINE_WIDTH", 0)
    use_alpha = ctx.knob_i("_USE_ALPHA", 1) > 0

    # ---- static polar geometry (radial/1.frag:44-70), over the band ---
    x, y = base.frag_coords(w, h, pixel_center_integer=False, rows=ctx.rows)
    dx = x[None, :] - (w // 2) + off_x
    dy = y[:, None] - (h // 2) + off_y
    theta = np.arctan2(dy, dx)                    # (H, W)
    dist = np.sqrt(dx * dx + dy * dy)

    ring = (dist > c_radius - c_line / 2.0) & (dist < c_radius + c_line / 2.0)
    ring_alpha = np.clip((c_line / 2.0 - np.abs(c_radius - dist)) * c_alias, 0.0, 1.0)

    section = TWOPI / nbars
    center = section / 2.0
    m = theta - section * np.floor(theta / section)   # GLSL mod
    ym = dist * np.sin(center - m)
    in_bar = (dist > c_radius) & (np.abs(ym) < bar_width / 2.0)

    idx = theta + rotate
    dirv = np.abs(idx) - TWOPI * np.floor(np.abs(idx) / TWOPI)
    idx = np.where(dirv > PI, -np.sign(idx) * (TWOPI - dirv), idx)
    if invert == 0:
        idx = -idx
    use_left = idx > 0

    if use_alpha:
        alias = (bar_width / 2.0 - np.abs(ym)) * bar_alias
        bar_d = dist - c_radius
    else:
        alias = np.ones_like(ym)
        bar_d = dist - (c_radius + c_line / 2.0)

    # sample at NBARS/2 + 1 distinct bar positions per channel
    n1 = nbars // 2 + 1
    bar_pos = np.arange(n1, dtype=np.float64) / float(nbars // 2)
    sample = ctx.sampler(np.clip(bar_pos, 0.0, 1.0))
    bar_id = np.clip((np.abs(idx) / section).astype(np.int64), 0, nbars // 2)
    # the per-pixel bar value: one lookup into cat([vl, vr]) (2 * n1)
    lookup_v = StaticLookup(bar_id + np.where(use_left, 0, n1), 2 * n1, dev)

    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    f32 = lambda a: t(np.asarray(a, np.float32))  # noqa: E731
    bar_d_t = f32(bar_d)
    bar_d_host = torch.as_tensor(np.asarray(bar_d, np.float32))
    ring_t = t(ring)
    ring_alpha_t = f32(ring_alpha)
    # built once, as the JAX module builds it (radial.py:99)
    outline_col = base.color_tensors(ctx.color_fn("OUTLINE")(), dev)

    def bar_values(textures) -> torch.Tensor:
        vl = sample(textures["audio_l"])                 # (S, n1)
        vr = sample(textures["audio_r"])
        return lookup_v(torch.cat([vl, vr], dim=-1) * amplify)  # (S, H, W)

    if bow <= 0 and use_alpha:
        # ---- default path: no bar outline, alpha AA ---------------------
        # in_bar folds into the alias plane (alias_enc >= 0 iff in_bar;
        # clip(alias) is the AA alpha) and the ring into its
        # premultiplied alpha f0a (0 off the ring); the ring layer is
        # static, the bar layer hangs on the pipe values only, so only the
        # body mask is per frame
        alias_enc = f32(np.where(in_bar, np.clip(alias, 0.0, 1.0), -1.0))
        f0a = torch.where(ring_t, outline_col[3] * ring_alpha_t, 0.0)
        one_m = 1.0 - torch.clamp(f0a, 0.0, 1.0)
        prem = [outline_col[k] * f0a for k in range(3)] + [f0a]

        def layers(c):
            """Each stream's planes where a bar is drawn (``prem``
            elsewhere)."""
            color = c["COLOR"]
            ca = color[3] * torch.clamp_min(alias_enc, 0.0)
            lit = [prem[k] + color[k] * one_m for k in range(3)]
            lit.append(torch.maximum(ca, f0a))
            return lit

        colors = base.StreamColors(ctx, ("COLOR",), derive=layers,
                                   d=bar_d_host)

        def pass1(inputs: base.PassInputs) -> base.Planes:
            v = bar_values(inputs.textures)
            body = (alias_enc >= 0.0) & (bar_d_t <= v)
            lit = colors(inputs.pipe)
            return tuple(torch.where(body, lit[k], prem[k]) for k in range(4))
    else:
        # ---- general path: a bar outline, or no alpha AA: the frame is
        # blended layer by layer as radial/1.frag does
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        in_bar_t = t(in_bar)
        alias_t = f32(alias)
        colors = base.StreamColors(ctx, ("COLOR", "BAR_OUTLINE"),
                                   d=bar_d_host)
        # compared in float32, as the JAX module compares its f32 |ym| plane
        inner = in_bar_t & t(np.abs(ym).astype(np.float32)
                             < np.float32(bar_width / 2.0 - bow))

        def aliased(col):
            return (*col[:3], col[3] * torch.clamp(alias_t, 0.0, 1.0))

        def pass1(inputs: base.PassInputs) -> base.Planes:
            v = bar_values(inputs.textures)
            cols = colors(inputs.pipe)
            color, bar_out = cols["COLOR"], cols["BAR_OUTLINE"]
            frag = (zero,) * 4
            # center ring (radial/1.frag:49-56)
            ring_col = list(_apply_frag(frag, outline_col, use_alpha))
            if use_alpha:
                ring_col[3] = ring_col[3] * ring_alpha_t
            frag = tuple(torch.where(ring_t, rc, f)
                         for rc, f in zip(ring_col, frag))

            # bars: COLOR / BAR_OUTLINE with d = distance past the circle
            body = in_bar_t & (bar_d_t <= v - bow)
            if bow > 0:
                edge = in_bar_t & (bar_d_t <= v) & ~body
                r = [torch.where(inner, c, bo) for c, bo in zip(color, bar_out)]
            else:
                edge = torch.zeros_like(body)
                r = color
            if use_alpha:
                r = aliased(r)
            drawn_body = _apply_frag(frag, r, use_alpha)
            frag2 = tuple(torch.where(body, db, f)
                          for db, f in zip(drawn_body, frag))
            if bow > 0:
                bo2 = aliased(bar_out) if use_alpha else bar_out
                drawn_edge = _apply_frag(frag, bo2, use_alpha)
                frag2 = tuple(torch.where(edge, de, f2)
                              for de, f2 in zip(drawn_edge, frag2))
            # `return`ed pixels skip the final blend; the rest get
            # APPLY_FRAG(fragment, transparent), a premultiply
            returned = body | edge
            final = _apply_frag(frag2, (zero,) * 4, use_alpha)
            return tuple(torch.where(returned, f2, fi)
                         for f2, fi in zip(frag2, final))

    passes = [pass1]
    if ctx.cfg.premultiply_alpha:
        passes.append(base.premultiply_pass)  # radial/2.frag
    return base.ModuleBuild("radial", passes, [lookup_v], batched=True,
                            banded=True, kind="native")


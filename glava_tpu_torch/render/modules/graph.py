"""`graph` module: filled stereo spectrum graph (4 passes).

Re-expression of shaders/glava/graph/{1,2,3,4}.frag:

* pass 1 (graph/1.frag) — filled columns from 3-tap smoothed samples
  with end-clamp easing and optional channel joining.
* pass 2 (graph/2.frag) — outline / edge highlight; disabled when
  both DRAW_OUTLINE and DRAW_HIGHLIGHT are 0 (`#error __disablestage`).
* pass 3 (graph/3.frag) — column anti-aliasing; disabled unless
  ANTI_ALIAS. The reference walks pixels up/down per column; pass 1's
  output is a contiguous fill, so the walk reduces to per-column top
  indices, computed vectorized. The colour it reads at each column's
  top is computed at that pixel from passes 1 and 2 (``column_tops``),
  so a band of rows renders without the rows the top lies in.
* pass 4 (graph/4.frag) — premultiply.

Every column-only quantity is baked in numpy; per frame the passes are
(S, W, 3) spectrum gathers and (S, H, W) masks. The module is batched
(``ModuleBuild.batched``). The COLOR knob depends only on the row
(``pos``) and on each stream's pipe values (``@fg``, read in the pass
as the JAX module does), evaluated on the device for every stream at
once from the step's pipe inputs (``base.StreamColors``); OUTLINE is
evaluated at build time, as in the JAX module, and keeps the load's
values.

Knobs (shaders/glava/graph.glsl): VSCALE, DIRECTION, GRADIENT, COLOR,
DRAW_OUTLINE, DRAW_HIGHLIGHT, ANTI_ALIAS, OUTLINE, JOIN_CHANNELS,
INVERT.
"""

from __future__ import annotations

import numpy as np
import torch

from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register
from glava_tpu_torch.render.modules.wave import crop_rows, neighbor_sum


@register("graph")
def build(ctx: base.ModuleContext) -> base.ModuleBuild:
    w, h = ctx.screen
    dev = ctx.device
    vscale = ctx.knob_f("VSCALE", 300)
    direction = ctx.knob_i("DIRECTION", 1)
    draw_outline = ctx.knob_i("DRAW_OUTLINE", 0)
    draw_highlight = ctx.knob_i("DRAW_HIGHLIGHT", 1)
    anti_alias = ctx.knob_i("ANTI_ALIAS", 0)
    join = ctx.knob_i("JOIN_CHANNELS", 0)
    invert = ctx.knob_i("INVERT", 0)
    outline = base.color_tensors(ctx.color_fn("OUTLINE")(), dev)

    # ---- static column math (graph/1.frag:62-104) -----------------------
    x, yrow = base.frag_coords(w, h, pixel_center_integer=True)
    half_w = float(w // 2)  # float(screen.x / 2): int division
    pixel = 1.0 / float(w)
    left_mask = x < half_w

    if direction < 0:
        left_idx, right_idx = x, -x + w
    else:
        left_idx, right_idx = half_w - x, x - half_w
    idx = np.where(left_mask, left_idx, right_idx) / half_w

    def adj_positions(i):
        """smooth_audio_adj taps (smooth.glsl:67-73)."""
        return np.stack(
            [np.maximum(i - pixel, 0.0), i, np.minimum(i + pixel, 1.0)], axis=-1
        )

    col_pos = np.clip(adj_positions(idx), 0.0, 1.0)        # (W, 3)
    mid_pos = np.clip(adj_positions(np.array([1.0, 0.0])), 0.0, 1.0)  # (2, 3)
    sample_cols = ctx.sampler(col_pos)
    sample_mid = ctx.sampler(mid_pos)

    fact_c = np.clip((np.abs(w // 2 - x) / w) * 48.0, 0.0, 1.0)
    if join > 0:
        fact_c = -2.0 * fact_c**3 + 3.0 * fact_c**2
    fact_e = np.clip((np.minimum(x, w - x) / w) * 48.0, 0.0, 1.0)

    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    left_mask_t = t(left_mask)
    fact_c_t = t(fact_c.astype(np.float32))
    fact_e_t = t(fact_e.astype(np.float32))

    # the row distances of the whole frame: pass 1 covers the band and,
    # when pass 2 reads its neighbours, the row on each side; pass 3
    # also reads each column's top, wherever it lies
    outline_on = draw_outline > 0 or draw_highlight > 0
    r0, r1 = ctx.band
    a0, a1 = ctx.widened(1) if outline_on else (r0, r1)
    halo = (r0 - a0, a1 - r1)
    d_rows = ((float(h) - yrow) if invert > 0 else yrow).astype(np.float32)
    d_all = t(d_rows)
    d_ext = d_all[a0:a1, None]
    d_col = d_all[r0:r1, None]
    colors = base.StreamColors(ctx, ("COLOR",),
                               pos=torch.as_tensor(d_rows)[:, None])

    def line_heights(textures) -> torch.Tensor:
        """Per-column s (graph/1.frag:87-104), shape (S, W)."""
        sl = torch.mean(sample_cols(textures["audio_l"]), dim=-1)
        sr = torch.mean(sample_cols(textures["audio_r"]), dim=-1)
        s = torch.where(left_mask_t, sl, sr) * vscale
        if join > 0:
            ml = torch.mean(sample_mid(textures["audio_l"]), dim=-1)[..., 0]
            mr = torch.mean(sample_mid(textures["audio_r"]), dim=-1)[..., 1]
            middle = (vscale * (ml + mr) / 2.0)[..., None]
            s = fact_c_t * s + (1.0 - fact_c_t) * middle
        else:
            s = s * fact_c_t
        return s * fact_e_t

    def fill(d, s, color) -> list:
        """graph/1.frag at row distances ``d`` against line heights
        ``s``."""
        mask = (d + 1.5) <= s
        return [torch.where(mask, c, 0.0) for c in color]

    def outline_highlight(frame, avg_a) -> list:
        """graph/2.frag from the pixel's planes and its neighbourhood
        alpha average. graph/2.frag only ever consumes avg.A (the
        outline branch writes a constant; the highlight multiplies by
        avg.a)."""
        alpha = frame[3]
        near = avg_a > 0
        out = list(frame)
        if draw_outline > 0:
            m = near & (alpha <= 0)
            out = [torch.where(m, outline[c], out[c]) for c in range(4)]
        if draw_highlight > 0:
            m = near & (alpha > 0) & (avg_a < 1)
            out[:3] = [torch.where(m, out[c] * (avg_a * 2.0), out[c])
                       for c in range(3)]
        return out

    def pass1(inputs: base.PassInputs) -> base.Planes:
        s = line_heights(inputs.textures)
        color = [base.cut_rows(c, a0, a1) for c in colors(inputs.pipe)["COLOR"]]
        return tuple(fill(d_ext, s[..., None, :], color))   # (S, rows, W)

    passes = [pass1]

    # graph/2.frag — outline + highlight
    if outline_on:
        def pass2(inputs: base.PassInputs) -> base.Planes:
            frame = inputs.prev
            # only the alpha plane feeds the neighbourhood average; the
            # rgb planes see one select each
            avg_a = neighbor_sum(frame[3], halo)
            return tuple(outline_highlight(
                [crop_rows(p, halo) for p in frame], avg_a))

        passes.append(pass2)

    def column_tops(s, rows_pix, pipe) -> list:
        """The planes passes 1 and 2 leave at each column's top pixel
        (rows_pix[x], x), (S, W) each, computed at that pixel and its
        neighbours (each stage through its [0, 1] clamp), so that a band
        reads them wherever the top lies."""
        cols = torch.arange(w, device=dev)
        color = [c.expand(s.shape[0], h, 1)[..., 0]
                 for c in colors(pipe)["COLOR"]]            # (S, H)

        def at(dy, dx):
            """Pass 1's planes at (rows_pix + dy, x + dx), zero outside
            the frame (texelFetch's zero padding)."""
            y, x = rows_pix + dy, cols + dx
            yc, xc = y.clamp(0, h - 1), x.clamp(0, w - 1)
            inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
            px = fill(d_all[yc], s[..., xc], [c.gather(-1, yc) for c in color])
            return [torch.where(inside, torch.clamp(p, 0.0, 1.0), 0.0)
                    for p in px]

        top = at(0, 0)
        if not outline_on:
            return top
        a = {(dy, dx): at(dy, dx)[3]
             for dy, dx in ((0, 1), (1, 1), (1, 0), (0, -1), (-1, -1), (-1, 0))}
        # the sum of wave.neighbor_sum, term for term
        avg_a = (2.0 * a[0, 1] + a[1, 1] + a[1, 0] + 2.0 * a[0, -1]
                 + a[-1, -1] + a[-1, 0]) / 8.0
        return [torch.clamp(p, 0.0, 1.0) for p in outline_highlight(top, avg_a)]

    # graph/3.frag — anti-alias: alpha-feather empty pixels between the
    # tops of adjacent columns.
    if anti_alias > 0:
        def pass3(inputs: base.PassInputs) -> base.Planes:
            frame = inputs.prev
            # contiguous fill: colored rows of column x are d in
            # [0, s-1.5] -> top index ty = floor(s - 1.5) in d-space
            s = line_heights(inputs.textures)                   # (S, W)
            ty = torch.floor(s - 1.5)
            edge = torch.full_like(ty[..., :1], -1.0)
            ty_l = torch.cat([edge, ty[..., :-1]], dim=-1)
            ty_r = torch.cat([ty[..., 1:], edge], dim=-1)
            empty = frame[3] <= 0
            # left / right neighbour colored at this row?
            lcol = d_col <= ty_l[..., None, :]
            rcol = d_col <= ty_r[..., None, :]
            h2 = ty  # own column top (first colored going down)
            # fragment colour of (x, h2), the column's top pixel
            rows = torch.clamp(ty, 0, h - 1).to(torch.int64)
            rows_pix = torch.clamp(h - rows, 0, h - 1) if invert > 0 else rows
            top = [p[:, None, :] for p in column_tops(s, rows_pix,
                                                      inputs.pipe)]
            # (ty_l - d) / (h2 - ty_l) is 0/0 where both vanish; the NaN
            # goes on through clamp/maximum as in the JAX module
            af_l = torch.clamp(torch.abs(
                (ty_l[..., None, :] - d_col) / (h2 - ty_l)[..., None, :]), 0.0, 1.0)
            af_r = torch.clamp(torch.abs(
                (ty_r[..., None, :] - d_col) / (h2 - ty_r)[..., None, :]), 0.0, 1.0)
            a_fact = torch.where(lcol, af_l, 0.0)
            a_fact = torch.maximum(a_fact, torch.where(rcol, af_r, 0.0))
            feather = empty & (lcol | rcol)
            new = top[:3] + [top[3] * a_fact]
            return tuple(torch.where(feather, new[c], frame[c]) for c in range(4))

        passes.append(pass3)

    if ctx.cfg.premultiply_alpha:
        passes.append(base.premultiply_pass)  # graph/4.frag

    return base.ModuleBuild("graph", passes, batched=True, banded=True,
                            kind="native")

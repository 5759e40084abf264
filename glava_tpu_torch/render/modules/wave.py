"""`wave` module: raw time-domain waveform line.

Re-expression of shaders/glava/wave/{1,2}.frag. Its one uniform takes
the ``window`` (a no-op without ``fft``) and ``wrange`` transforms, so
the texture holds the feed PCM mapped to [0, 1] (wave/1.frag:7-9) and
the module keeps no spectrum state. Pass 1 draws the line with
adaptive thickness; pass 2 is an unconditional neighbourhood outline
pass. The per-column texel indices are static (numpy); per frame the
pass is three (S, W) gathers and (S, H, W) masks. The module is batched
(``ModuleBuild.batched``). BASE_COLOR and OUTLINE are evaluated once at
build time, as in the JAX module (wave.py:37-38), so they keep the
load's ``@fg``/``@bg`` values whatever a step's pipe values. Built for a
band of rows, pass 1 covers the band widened by the one row on each
side that pass 2's neighbourhood reads.

Knobs (shaders/glava/wave.glsl): MIN_THICKNESS, MAX_THICKNESS,
BASE_COLOR, AMPLIFY, OUTLINE.
"""

from __future__ import annotations

import numpy as np
import torch

from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register


def _texture_nearest_repeat(coords: np.ndarray, sz: int) -> np.ndarray:
    """GL `texture()` lookup indices: NEAREST filter, REPEAT wrap
    (render.c:512-517)."""
    u = coords - np.floor(coords)
    return np.minimum(np.floor(u * sz), sz - 1).astype(np.int64)


@register(
    "wave",
    uniforms=(("audio_l", "audio_l", ("window", "wrange")),),  # wave/1.frag:7-9
)
def build(ctx: base.ModuleContext) -> base.ModuleBuild:
    w, h = ctx.screen
    dev = ctx.device
    min_t = ctx.knob_f("MIN_THICKNESS", 1)
    max_t = ctx.knob_f("MAX_THICKNESS", 6)
    amplify = ctx.knob_f("AMPLIFY", 500)
    base_color = base.color_tensors(ctx.color_fn("BASE_COLOR")(), dev)
    outline = base.color_tensors(ctx.color_fn("OUTLINE")(), dev)

    # pixel_center_integer: integer fragment coords (wave/1.frag:2); pass
    # 1 over the band and the row on each side pass 2 reads
    r0, r1 = ctx.band
    a0, a1 = ctx.widened(1)
    halo = (r0 - a0, a1 - r1)
    x, y = base.frag_coords(w, h, pixel_center_integer=True, rows=(a0, a1))
    taps = [torch.as_tensor(_texture_nearest_repeat(c / w, ctx.sz), device=dev)
            for c in (x, x - 1, x + 1)]
    y_col = torch.as_tensor(y.astype(np.float32), device=dev)[:, None]

    def pass1(inputs: base.PassInputs) -> base.Planes:
        tex = inputs.textures["audio_l"]                 # (S, sz)
        os_, om, op = ((tex[..., ix] - 0.5) * amplify + 0.5 for ix in taps)
        s0 = om - os_
        s1 = op - os_
        dmax = torch.maximum(s0, s1)[..., None, :]
        dmin = torch.minimum(s0, s1)[..., None, :]

        s = os_ + (h * 0.5) - 0.5
        diff = y_col - s[..., None, :]                   # (S, H, W)
        thick = torch.clamp(torch.abs(s - (h * 0.5)) * 6.0, min_t, max_t)
        on_line = torch.abs(diff) < thick[..., None, :]
        in_slope = (diff <= dmax) & (diff >= dmin)
        mask = on_line | in_slope

        # BASE_COLOR + scalar brightens all components incl. alpha
        # (wave/1.frag:35)
        bright = (torch.abs((h * 0.5) - s) * 0.02)[..., None, :]
        return tuple(torch.where(mask, base_color[c] + bright, 0.0)
                     for c in range(4))

    def pass2(inputs: base.PassInputs) -> base.Planes:
        return neighbor_outline_pass(inputs.prev, outline, edge_columns=True,
                                     halo=halo)

    return base.ModuleBuild("wave", [pass1, pass2], batched=True, banded=True,
                            kind="native")


def crop_rows(plane, halo: tuple[int, int]):
    """``plane`` without the ``halo`` = (below, above) rows beyond its
    band (a plane broadcast over rows stays as it is)."""
    if not any(halo) or np.ndim(plane) < 2:
        return plane
    return base.cut_rows(plane, halo[0], plane.shape[-2] - halo[1])


def neighbor_sum(alpha: torch.Tensor,
                 halo: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """The 8-fetch neighbourhood average of the outline passes
    (wave/2.frag:14-32, graph/2.frag, circle/2.frag): the reference
    fetches (+1, 0) and (-1, 0) twice each, and an out-of-bounds
    texelFetch reads as transparent black (zero padding). ``alpha``
    may hold ``halo`` = (below, above) rows beyond the output's band,
    at most one each: the band's neighbours inside the frame; the rows
    it lacks lie outside the frame and read as zero."""
    lo, hi = halo
    h, w = alpha.shape[-2] - lo - hi, alpha.shape[-1]
    p = torch.nn.functional.pad(alpha, (1, 1, 1 - lo, 1 - hi))

    def sh(dy, dx):  # neighbour at (x+dx, y+dy)
        return p[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    return (
        2.0 * sh(0, 1) + sh(1, 1) + sh(1, 0) + 2.0 * sh(0, -1)
        + sh(-1, -1) + sh(-1, 0)
    ) / 8.0


def neighbor_outline_pass(frame: base.Planes, outline: list[torch.Tensor],
                          edge_columns: bool,
                          halo: tuple[int, int] = (0, 0)) -> base.Planes:
    """wave/2.frag: outline colour where the neighbourhood alpha average
    is positive and the pixel itself is transparent (or, with
    ``edge_columns``, in the first or last column). Only the alpha plane
    feeds the average; the rgb planes see one select each. ``frame``
    may hold ``halo`` rows beyond the band (:func:`neighbor_sum`); the
    result covers the band."""
    cond = neighbor_sum(frame[3], halo) > 0
    frame = tuple(crop_rows(p, halo) for p in frame)
    alpha = frame[3]
    w = alpha.shape[-1]
    inner = alpha <= 0
    if edge_columns:
        col = torch.arange(w, device=alpha.device)
        inner = inner | ((col == 0) | (col == w - 1))[None, :]
    mask = cond & inner
    return tuple(torch.where(mask, outline[c], frame[c])
                 for c in range(4))

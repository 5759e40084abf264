"""`radial` (shaders/glava/radial/{1,2}.frag): NBARS bars around a ring,
alpha anti-aliased, no bar outline, then premultiplied.

A pixel's angle picks its bar and side; the bar's spectrum value times
AMPLIFY is its length past C_RADIUS. The ring (C_LINE wide) takes
OUTLINE with its anti-aliasing alpha; a pixel inside a bar's width and
length takes COLOR (the pipe value ``fg``, else ``mix(COLOR_FROM,
COLOR_TO, clamp(d / GRADIENT, 0, 1))`` by its distance ``d`` past the
ring) blended over the ring by APPLY_FRAG. OUTLINE is the load's: the
program evaluates it once, when the module is built.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import common
from reference.common import PI, TWOPI


class Module:
    def __init__(self, knobs: dict, w: int, h: int, sz: int, device):
        if float(knobs["BAR_OUTLINE_WIDTH"]) > 0 or not int(knobs["_USE_ALPHA"]):
            raise ValueError("the radial reference draws the shipped path: "
                             "no bar outline, alpha anti-aliasing on")
        dev = self.device = torch.device(device)
        self.w, self.h = w, h
        c_radius, c_line = float(knobs["C_RADIUS"]), float(knobs["C_LINE"])
        nbars = int(knobs["NBARS"])
        bar_width = float(knobs["BAR_WIDTH"])
        self.amplify = float(knobs["AMPLIFY"])
        x = np.arange(w, dtype=np.float64) + 0.5
        y = np.arange(h, dtype=np.float64) + 0.5
        dx = x[None, :] - (w // 2) + float(knobs["CENTER_OFFSET_X"])
        dy = y[:, None] - (h // 2) + float(knobs["CENTER_OFFSET_Y"])
        theta = np.arctan2(dy, dx)
        dist = np.sqrt(dx * dx + dy * dy)
        ring = (dist > c_radius - c_line / 2.0) & (dist < c_radius + c_line / 2.0)
        ring_alpha = np.clip((c_line / 2.0 - np.abs(c_radius - dist))
                             * float(knobs["C_ALIAS_FACTOR"]), 0.0, 1.0)
        section = TWOPI / nbars
        m = theta - section * np.floor(theta / section)
        ym = dist * np.sin(section / 2.0 - m)
        in_bar = (dist > c_radius) & (np.abs(ym) < bar_width / 2.0)
        idx = theta + float(knobs["ROTATE"])
        dirv = np.abs(idx) - TWOPI * np.floor(np.abs(idx) / TWOPI)
        idx = np.where(dirv > PI, -np.sign(idx) * (TWOPI - dirv), idx)
        if int(knobs["INVERT"]) == 0:
            idx = -idx
        alias = (bar_width / 2.0 - np.abs(ym)) * float(knobs["BAR_ALIAS_FACTOR"])
        bar_d = dist - c_radius
        half = nbars // 2
        n1 = half + 1
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        self.sample = t(common.texel_round(np.arange(n1) / float(half), sz))
        bar_id = np.clip((np.abs(idx) / section).astype(np.int64), 0, half)
        self.ids = t(bar_id + np.where(idx > 0, 0, n1))
        self.alias_enc = t(np.where(in_bar, np.clip(alias, 0.0, 1.0),
                                    -1.0).astype(np.float32))
        self.bar_d = t(bar_d.astype(np.float32))
        outline = [t(np.float32(c)) for c in common.hex_color(knobs["OUTLINE_COLOR"])]
        f0a = torch.where(t(ring), outline[3] * t(ring_alpha.astype(np.float32)),
                          0.0)
        self.one_m = 1.0 - torch.clamp(f0a, 0.0, 1.0)
        self.prem = [outline[c] * f0a for c in range(3)] + [f0a]
        c0 = np.asarray(common.hex_color(knobs["COLOR_FROM"]))
        c1 = np.asarray(common.hex_color(knobs["COLOR_TO"]))
        mixt = np.clip(bar_d.astype(np.float32) / float(knobs["GRADIENT"]),
                       0.0, 1.0)[..., None]
        grad = common.mix(c0, c1, mixt)
        self.color = [t(grad[..., c].astype(np.float32))[None] for c in range(4)]

    def render(self, tex: dict, feed: torch.Tensor, pipe: dict | None):
        S = tex["audio_l"].shape[0]
        vals = torch.cat([tex["audio_l"][:, self.sample],
                          tex["audio_r"][:, self.sample]], dim=-1) * self.amplify
        v = vals[:, self.ids]                                   # (S, H, W)
        color = common.stream_color(pipe, "fg", S, self.device) or self.color
        lit = [self.prem[c] + color[c] * self.one_m for c in range(3)]
        lit.append(torch.maximum(color[3] * torch.clamp_min(self.alias_enc, 0.0),
                                 self.prem[3]))
        body = (self.alias_enc >= 0.0) & (self.bar_d <= v)
        planes = common.clip([torch.where(body, lit[c], self.prem[c])
                              for c in range(4)])
        r, g, b, a = planes                                     # radial/2.frag
        return common.to_u8(common.clip([r * a, g * a, b * a, a]),
                            (S, self.h, self.w))

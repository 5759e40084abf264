"""`bars` (shaders/glava/bars/1.frag), two channels, no alpha pass.

Column by column: the bar a column belongs to, its spectrum position
and side, then rows below ``v - BAR_OUTLINE_WIDTH`` take COLOR inside
the outline and BAR_OUTLINE on it, rows up to ``v`` BAR_OUTLINE. COLOR
is the pipe value ``fg`` where a stream binds it, else
``mix(COLOR_FROM, COLOR_TO, clamp(d / GRADIENT, 0, 1))`` by the row's
height ``d``; BAR_OUTLINE is ``bg``, else COLOR's rgb times
OUTLINE_SCALE.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import common


class Module:
    def __init__(self, knobs: dict, w: int, h: int, sz: int, device):
        dev = self.device = torch.device(device)
        self.w, self.h = w, h
        bw, gap = float(knobs["BAR_WIDTH"]), float(knobs["BAR_GAP"])
        self.bow = float(knobs["BAR_OUTLINE_WIDTH"])
        self.amplify = float(knobs["AMPLIFY"])
        x = np.arange(w, dtype=np.float64) + 0.5
        y = np.arange(h, dtype=np.float64) + 0.5
        dx = x - (w // 2)
        section = bw + gap
        center = section / 2.0
        m = np.abs(dx - section * np.floor(dx / section))
        md = m - center
        in_bar = (md < np.ceil(bw / 2.0)) & (md >= -np.floor(bw / 2.0))
        inner = ((md < np.ceil(bw / 2.0) - self.bow)
                 & (md >= -np.floor(bw / 2.0) + self.bow))
        nbars = np.floor((w * 0.5) / section) * 2.0
        s = dx / section
        p = np.where(s > 0, np.ceil(s), np.floor(s)) / (nbars / 2.0)
        p = p + np.sign(p) * ((0.5 + center) / w)
        visible = in_bar & ~((p > 1.0) | (p < -1.0))
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        self.idx = t(common.texel_round(np.abs(p), sz))
        self.right = t(p > 0)
        self.visible = t(visible)
        self.inner = t(inner & visible)
        self.d = t(y.astype(np.float32))[:, None]            # (H, 1)
        c0 = np.asarray(common.hex_color(knobs["COLOR_FROM"]))
        c1 = np.asarray(common.hex_color(knobs["COLOR_TO"]))
        mixt = np.clip(y / float(knobs["GRADIENT"]), 0.0, 1.0)[:, None]
        grad = common.mix(c0, c1, mixt)                        # (H, 4)
        self.color = [t(grad[:, c].astype(np.float32))[None, :, None]
                      for c in range(4)]
        self.k = float(knobs["OUTLINE_SCALE"])

    def render(self, tex: dict, feed: torch.Tensor, pipe: dict | None):
        S = tex["audio_l"].shape[0]
        v = torch.where(self.right, tex["audio_r"][:, self.idx],
                        tex["audio_l"][:, self.idx]) * self.amplify
        v = torch.where(self.visible, v, -torch.inf)[:, None, :]   # (S, 1, W)
        body = self.d < v - np.float32(self.bow)
        color = common.stream_color(pipe, "fg", S, self.device) or self.color
        if self.bow <= 0:
            planes = [torch.where(body, c, 0.0) for c in color]
            return common.to_u8(common.clip(planes), (S, self.h, self.w))
        outline = (common.stream_color(pipe, "bg", S, self.device)
                   or [c * self.k for c in color[:3]] + [color[3]])
        edge = self.d <= v
        fill = body & self.inner
        rim = (edge & ~body) | (body & ~self.inner)
        planes = [torch.where(fill, c, torch.where(rim, o, 0.0))
                  for c, o in zip(color, outline)]
        return common.to_u8(common.clip(planes), (S, self.h, self.w))

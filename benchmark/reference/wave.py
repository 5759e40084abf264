"""`wave` (shaders/glava/wave/{1,2}.frag): the newest PCM of the left
channel as a line, thicker away from the centre, then an outline.

Its one uniform takes ``window`` (a no-op without ``fft``) and
``wrange``: the texture is the feed snapshot mapped from [-1, 1] to
[0, 1], fetched NEAREST with REPEAT wrap at each column and its two
neighbours. BASE_COLOR and OUTLINE are the load's (evaluated once at
build).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import common


class Module:
    def __init__(self, knobs: dict, w: int, h: int, sz: int, device):
        dev = self.device = torch.device(device)
        self.w, self.h = w, h
        self.min_t = float(knobs["MIN_THICKNESS"])
        self.max_t = float(knobs["MAX_THICKNESS"])
        self.amplify = float(knobs["AMPLIFY"])
        x = np.arange(w, dtype=np.float64)           # pixel_center_integer
        y = np.arange(h, dtype=np.float64)

        def nearest_repeat(c):
            u = c - np.floor(c)
            return torch.as_tensor(
                np.minimum(np.floor(u * sz), sz - 1).astype(np.int64), device=dev)

        self.taps = [nearest_repeat(c / w) for c in (x, x - 1, x + 1)]
        self.y = torch.as_tensor(y.astype(np.float32), device=dev)[:, None]
        self.base = [float(np.float32(c)) for c in knobs["BASE_RGBA"]]
        self.outline = [float(np.float32(c)) for c in knobs["OUTLINE_RGBA"]]

    def render(self, tex: dict, feed: torch.Tensor, pipe: dict | None):
        S = feed.shape[0]
        h, w = self.h, self.w
        t = torch.clamp((feed[:, 0, :].float() + 1.0) / 2.0, 0.0, 1.0)
        os_, om, op = ((t[:, ix] - 0.5) * self.amplify + 0.5 for ix in self.taps)
        s0, s1 = om - os_, op - os_
        dmax = torch.maximum(s0, s1)[:, None, :]
        dmin = torch.minimum(s0, s1)[:, None, :]
        s = os_ + (h * 0.5) - 0.5
        diff = self.y - s[:, None, :]
        thick = torch.clamp(torch.abs(s - (h * 0.5)) * 6.0, self.min_t, self.max_t)
        mask = (torch.abs(diff) < thick[:, None, :]) | ((diff <= dmax)
                                                         & (diff >= dmin))
        bright = (torch.abs((h * 0.5) - s) * 0.02)[:, None, :]
        p1 = common.clip([torch.where(mask, c + bright, 0.0) for c in self.base])
        cond = common.neighbor_sum(p1[3]) > 0                # wave/2.frag
        col = torch.arange(w, device=self.device)
        inner = (p1[3] <= 0) | ((col == 0) | (col == w - 1))[None, None, :]
        out = [torch.where(cond & inner, o, p) for o, p in zip(self.outline, p1)]
        return common.to_u8(common.clip(out), (S, h, w))

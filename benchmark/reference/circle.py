"""`circle` (shaders/glava/circle/{1,2,3}.frag): a ring displaced by the
spectrum, the C_SMOOTH neighbourhood pass, then premultiplied.

Each pixel samples the texture at its own angle and at +-adv along the
ring (adv = C_LINE / 2 over its distance), the samples times AMPLIFY
displacing the ring; it is drawn when within C_LINE / 2 of the displaced
ring or between its neighbours' displacements (slope filling). Pass 2
fills an undrawn pixel with the average of its neighbourhood; all of it
in OUTLINE, the load's colour (evaluated once at build).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import common
from reference.common import PI, TWOPI


def _position(theta, rotate: float, invert: int):
    idx = theta + rotate
    dirv = np.abs(idx) - TWOPI * np.floor(np.abs(idx) / TWOPI)
    idx = np.where(dirv > PI, -np.sign(idx) * (TWOPI - dirv), idx)
    if invert > 0:
        idx = -idx
    return np.abs(idx) / (PI + 0.001), idx > 0


class Module:
    def __init__(self, knobs: dict, w: int, h: int, sz: int, device):
        if int(knobs["C_FILL"]) or not int(knobs["C_SMOOTH"]) \
                or not int(knobs["_USE_ALPHA"]):
            raise ValueError("the circle reference draws the shipped path: "
                             "C_FILL 0, C_SMOOTH 1, alpha on")
        dev = self.device = torch.device(device)
        self.w, self.h = w, h
        c_radius, self.c_line = float(knobs["C_RADIUS"]), float(knobs["C_LINE"])
        self.amplify = float(knobs["AMPLIFY"])
        x = np.arange(w, dtype=np.float64)           # pixel_center_integer
        y = np.arange(h, dtype=np.float64)
        dx = x[None, :] - (w // 2)
        dy = y[:, None] - (h // 2)
        theta = np.arctan2(dy, dx)
        dist = np.sqrt(dx * dx + dy * dy)
        with np.errstate(divide="ignore"):
            adv = np.where(dist > 0, (self.c_line * 0.5) / np.maximum(dist, 1e-6),
                           0.0)
        sites = []
        for th in (theta, theta + adv, theta - adv):
            pos, left = _position(th, float(knobs["ROTATE"]), int(knobs["INVERT"]))
            p32 = np.clip(pos, 0.0, 1.0).astype(np.float32)
            tx = np.clip(np.round(p32 * np.float32(sz)), 0, sz - 1).astype(np.int64)
            sites.append(tx + np.where(left, 0, sz))
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        self.sites = t(np.stack(sites))                          # (3, H, W)
        d0 = dist - c_radius
        self.d0 = t(d0.astype(np.float32))
        self.active = t(d0 >= -(self.c_line / 2.0))
        self.outline = [float(np.clip(np.float32(c), 0.0, 1.0))
                        for c in common.hex_color(knobs["OUTLINE_COLOR"])]

    def render(self, tex: dict, feed: torch.Tensor, pipe: dict | None):
        S = tex["audio_l"].shape[0]
        table = torch.cat([tex["audio_l"], tex["audio_r"]], dim=-1)
        v, vp, vm = (table[:, self.sites] * self.amplify).unbind(1)
        a0, a1 = vp - v, vm - v
        dmax, dmin = torch.maximum(a0, a1), torch.minimum(a0, a1)
        d = self.d0 - v
        half = self.c_line / 2.0
        bounds = ((d > -half) & (d < half)) | ((d <= dmax) & (d >= dmin))
        m = (self.active & bounds).to(torch.float32)
        wsum = common.neighbor_sum(m)
        o = self.outline
        coef = wsum if o[3] == 0.0 else torch.where(m > 0, 1.0, wsum)
        a = o[3] * coef
        planes = [(o[0] * coef) * a, (o[1] * coef) * a, (o[2] * coef) * a, a]
        return common.to_u8(common.clip(planes), (S, self.h, self.w))

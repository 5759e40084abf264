"""`rings` (docs/examples/rings/{1,2}.frag), a user GLSL module: an
audio-driven ring, then a horizontal smear of it.

Written from GLSL's and GLava's semantics. A pixel is drawn at its
centre, ``gl_FragCoord = (x + 0.5, y + 0.5)``, row 0 the bottom row.

Pass 1 (1.frag):

* ``p = gl_FragCoord.xy - (W / 2, H / 2)``, ``d = length(p)``,
  ``pos = |atan(p.y, p.x)| / 3.14159265`` (the shader's literal, not pi);
* ``v = smooth_audio(audio_l, audio_sz, pos)``: with the smooth pass on
  (GLava's ``util/smooth.glsl``, ``_PRE_SMOOTHED_AUDIO``) that is
  ``texelFetch(audio_l, int(round(pos * sz)))``, the texel clamped into
  the texture;
* the ring: radius ``0.25 H + 0.5 H v``, width ``2 + 10 v``;
  ``a = 1 - band / width`` where ``band = |d - radius| < width``, else
  0;
* the dither: ``((hx << 3) ^ (hy << 1) ^ (hx >> 2)) & 255`` on 32-bit
  ints (``hx = int(gl_FragCoord.x)`` truncates to the column; ``>>`` is
  arithmetic), over 255, times 0.04, added where ``a > 0``, and ``a``
  clamped to [0, 1];
* the shade: ``q = mat2(0.8, -0.6, 0.6, 0.8) * normalize(p + (1e-4,
  0))``; GLSL's ``mat2`` takes its arguments column by column, so ``q.y
  = -0.6 n.x + 0.8 n.y``; ``g = 0.6 + 0.4 q.y``;
* ``fragment = vec4((0.2, 0.7, 1.0) * (a * g), a)``.

GLava's stage framebuffers are 8-bit normalized RGBA textures
(render.c:543-556): a pass's output is clamped to [0, 1] and stored as
``round(x * 255) / 255``, which is what pass 2 reads.

Pass 2 (2.frag): ``cur = texelFetch(prev, pixel)``; ``l1``, ``l2`` =
``texture(prev, uv - (k / W, 0))`` for k = 1, 2, ``uv =
gl_FragCoord.xy / (W, H)``. A stage texture samples NEAREST with REPEAT
wrap: texel ``floor(fract(u) * W)``, so column x reads columns x - 1
and x - 2, and columns 0 and 1 read from W - 1 and W - 2. Out: ``max(cur,
max(0.7 l1, 0.45 l2))``.

With rc.glsl's native opacity (``premultiply_alpha``) GLava draws the
last stage's texture as it is (the blend over the background is the
other opacities'), so nothing is applied after pass 2: the frame is
``round(clamp(x) * 255)``.

Precision: every value is float32, as GLSL's ``float``. What depends on
the pixel alone (``d``, ``pos`` and its texel, the dither, ``g``, the
smear's columns) is worked out once, on the host, in numpy float32; the
rest on the device each frame. ``dtype`` below float32 (float16,
bfloat16) rounds those planes to it and draws every frame in it, the
texel index left as float32 gives it: a raster in lower precision, a
control that the pixel rule must fail.

Departures from a GL implementation: ``round`` rounds half to even
(GLSL leaves the direction of a half to the implementation), and the
transcendentals (``atan``, ``sqrt``) are numpy's float32 ones, which may
differ from a GPU's in the last ulp. A pixel whose texel ``pos * sz`` lies that
close to a half is drawn from numpy's ``atan``.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import common

F = np.float32
COLOR = (0.2, 0.7, 1.0)          # Ring.color
SMEAR = (0.7, 0.45)              # the weights of l1 and l2


def _repeat_texel(u: np.ndarray, n: int) -> np.ndarray:
    """NEAREST with REPEAT wrap: the texel ``floor(fract(u) * n)`` of
    float32 coordinates ``u``."""
    f = u - np.floor(u)
    return np.clip(np.floor(f * F(n)), 0, n - 1).astype(np.int64)


class Module:
    def __init__(self, knobs: dict, w: int, h: int, sz: int, device,
                 dtype=torch.float32):
        if knobs:
            raise ValueError(f"rings takes no knobs, got {sorted(knobs)}")
        dev = self.device = torch.device(device)
        self.w, self.h, self.dtype = w, h, dtype
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        fx = np.arange(w, dtype=F) + F(0.5)              # gl_FragCoord.x
        fy = np.arange(h, dtype=F) + F(0.5)              # gl_FragCoord.y
        with np.errstate(all="ignore"):
            px = (fx - F(w / 2.0))[None, :]              # (1, W)
            py = (fy - F(h / 2.0))[:, None]              # (H, 1)
            d = np.sqrt(px * px + py * py)               # length(p)
            pos = np.abs(np.arctan2(py, px)) / F(3.14159265)
            # normalize(p + vec2(0.0001, 0.0)), then rot * n
            nx0 = px + F(0.0001)
            ln = np.sqrt(nx0 * nx0 + py * py)
            nx, ny = nx0 / ln, py / ln
            qy = F(-0.6) * nx + F(0.8) * ny
            g = F(0.6) + F(0.4) * qy
        hx = np.arange(w, dtype=np.int32)[None, :]       # int(gl_FragCoord.x)
        hy = np.arange(h, dtype=np.int32)[:, None]
        hsh = ((hx << 3) ^ (hy << 1) ^ (hx >> 2)) & 255
        dither = hsh.astype(F) / F(255.0) * F(0.04)
        self.d = t(np.broadcast_to(d, (h, w)).astype(F)).to(dtype)
        # int(round(pos * tex_sz)), pos clamped to [0, 1], in float32
        texel = np.round(np.clip(pos, F(0.0), F(1.0)) * F(sz))
        self.idx = t(np.clip(texel, 0, sz - 1).astype(np.int64))
        self.dither = t(dither.astype(F)).to(dtype)
        self.g = t(np.broadcast_to(g, (h, w)).astype(F)).to(dtype)
        self.radius0, self.radius1 = 0.25 * h, 0.5 * h
        # pass 2: uv.x - k / W, sampled NEAREST with REPEAT (uv.y
        # samples the pixel's own row)
        uvx = fx / F(w)
        self.cols = [t(_repeat_texel(uvx - F(k) / F(w), w)) for k in (1, 2)]

    def render(self, tex: dict, feed: torch.Tensor, pipe: dict | None):
        S = tex["audio_l"].shape[0]
        v = tex["audio_l"].to(self.dtype)[:, self.idx]        # (S, H, W)
        radius = self.radius0 + self.radius1 * v
        width = 2.0 + 10.0 * v
        band = torch.abs(self.d - radius)
        a = torch.where(band < width, 1.0 - band / width, 0.0)
        a = torch.clamp(a + torch.where(a > 0.0, self.dither, 0.0), 0.0, 1.0)
        ag = a * self.g
        first = [c * ag for c in COLOR] + [a]
        # the stage's 8-bit framebuffer
        prev = [torch.round(p * 255.0) / 255.0 for p in common.clip(first)]
        out = [torch.maximum(p, torch.maximum(SMEAR[0] * p[..., self.cols[0]],
                                              SMEAR[1] * p[..., self.cols[1]]))
               for p in prev]
        return common.to_u8(common.clip(out), (S, self.h, self.w))

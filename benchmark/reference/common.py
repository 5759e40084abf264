"""What the reference's module rasters share: GLava's constants, colours,
the 8-tap neighbourhood of the outline passes and the uint8 frame."""

from __future__ import annotations

import numpy as np
import torch

PI = 3.14159265359       # util/common.glsl
TWOPI = 6.28318530718


def hex_color(text: str) -> tuple[float, ...]:
    """``#rrggbb`` or ``#rrggbbaa`` -> RGBA in [0, 1]."""
    h = text.lstrip("#")
    if len(h) not in (6, 8):
        raise ValueError(f"not a colour: {text!r}")
    vals = [int(h[i:i + 2], 16) / 255.0 for i in range(0, len(h), 2)]
    return tuple(vals + [1.0] * (4 - len(vals)))


def mix(a, b, t):
    """GLSL ``mix``: ``a * (1 - t) + b * t``."""
    return a * (1.0 - t) + b * t


def texel_round(pos, sz: int) -> np.ndarray:
    """The smooth pass's texel fetch ``round(pos * sz)`` of positions in
    [0, 1] (float64, round half to even), clipped into the texture."""
    p = np.clip(np.asarray(pos, np.float64), 0.0, 1.0)
    return np.clip(np.round(p * sz), 0, sz - 1).astype(np.int64)


def neighbor_sum(alpha: torch.Tensor) -> torch.Tensor:
    """The outline passes' 8-fetch average (wave/2.frag:14-32,
    circle/2.frag): (+1, 0) and (-1, 0) fetched twice, texels outside
    the frame read as zero."""
    h, w = alpha.shape[-2:]
    p = torch.nn.functional.pad(alpha, (1, 1, 1, 1))

    def at(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    return (2.0 * at(0, 1) + at(1, 1) + at(1, 0) + 2.0 * at(0, -1)
            + at(-1, -1) + at(-1, 0)) / 8.0


def clip(planes):
    """An 8-bit stage write clamps every channel to [0, 1]."""
    return [torch.clamp(p, 0.0, 1.0) for p in planes]


def to_u8(planes, shape) -> torch.Tensor:
    """Channel planes broadcast to ``shape`` (S, H, W) -> (S, H, W, 4)
    uint8: ``round(clip(x) * 255)``, half to even."""
    out = [torch.clamp(torch.round(torch.clamp(p, 0.0, 1.0).expand(shape)
                                   * 255.0), 0, 255).to(torch.uint8)
           for p in planes]
    return torch.stack(out, dim=-1)


def stream_color(pipe: dict | None, name: str, S: int, device):
    """A pipe value ``name`` as (S, 1, 1) float32 RGBA components, or
    None when no stream binds it."""
    if not pipe or name not in pipe:
        return None
    v = torch.as_tensor(np.asarray(pipe[name], np.float32), device=device)
    return [v[:, c].reshape(S, 1, 1) for c in range(4)]

"""The table of peaks and the kernels' operations and bytes.

Frozen copies of the port's sound arithmetic (``glava_tpu_torch/utils/
timing.py`` ``update_bytes``, ``fused_bound``; the bars raster's bytes
as ``chip_smoke.py`` counts them), kept here so that no later change to
the program moves the yardstick. Peaks: NVIDIA H100 SXM data sheet,
dense, at the full 700 W.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12   # device memory
FP64_FLOPS = 34e12          # float64 outside the tensor cores


def update_bytes(n: int, B: int, F: int) -> int:
    """Bytes the fused update must move at bufsize ``n`` over ``B`` rows
    with ``F`` averaging frames. Read once: pcm, window, weights, slots
    and 3 row parameters, gravity and the F - 1 history slots a row does
    not overwrite. Written once: gravity, that slot and the average."""
    plane = B * n * 4            # one (B, 2, m) float32 plane set
    return (B * n * 4 + n * 4 + F * 4 + 4 * B * 4 + plane + (F - 1) * plane
            + 3 * plane)


def update_bound_s(n: int, B: int, F: int) -> float:
    """The fused update's least time: the larger of its bytes over the
    memory rate and its float64 FFT (5 m log2 m flops a row, m = n/2)
    over the float64 rate."""
    m = n // 2
    return max(update_bytes(n, B, F) / HBM_BYTES_PER_S,
               B * 5 * m * math.log2(m) / FP64_FLOPS)


def raster_bytes(S: int, H: int, W: int, color_rows: int) -> int:
    """Bytes of the bars raster's inputs and outputs, each once: the
    (S, 4, H, W) float32 planes written; the (S, W) heights, the (W,)
    inner mask, the (H,) row distances and two (color_rows, H, 4)
    colour tables read."""
    return (S * 4 * H * W * 4 + S * W * 4 + W + H * 4
            + 2 * color_rows * H * 16)


def raster_bound_s(S: int, H: int, W: int, color_rows: int) -> float:
    return raster_bytes(S, H, W, color_rows) / HBM_BYTES_PER_S

"""Each frame's gravity step, as GLava's loop feeds its measured update
rate back into it (``render.c:728``, ``2376-2399``), plainly.

A run of the loop starts at the nominal rate (the sample rate over the
hop) and, once a second, measures each stream's updates a second: its
frames with fresh audio since the last such tick, over the seconds
between the two ticks, held at an eighth of the nominal rate or more
against stalls. Every frame's step is ``gravity_step / max(rate, 1)``
in float32. The tick after a frame counts that frame's update; the
frame after it takes the new rate.

The updates are counted here from the frames' ``modified`` flags. The
seconds between two ticks cannot be read to the microsecond from the
frames' times, so the span taken is the one the program's measured rate
implies (updates over rate), where it lies inside what the times allow
(at least a second), and the nearest such span otherwise. So a program
whose rate, formula or guard is wrong gets other steps than these; a
tick that the times show was due and did not come is counted as a
fault.
"""

from __future__ import annotations

import numpy as np

# slack on the host-clock bounds of a tick (the loop's clock is the same
# CLOCK_MONOTONIC; this covers the rounding of the stamps)
SLACK_S = 1e-3


def steps(runs: list, times: np.ndarray, ticks: np.ndarray,
          mods: np.ndarray, ups: np.ndarray, dsp: dict) -> tuple:
    """(g, faults): the (K, S) float32 gravity steps of every frame and
    the number of ticks that were due and did not come.

    ``runs``: (first frame, host time of the call) of each run of the
    loop, in order; ``times``: (K, 2) each frame's step start and end on
    the host clock; ``ticks``: (K,) whether the program's measured rate
    is a new one at frame ``k`` (a tick after frame ``k - 1``);
    ``mods``: (K, S) the frames' ``modified`` flags; ``ups``: (K, S) the
    program's measured rate at each frame."""
    K, S = mods.shape
    nominal = float(dsp["sample_rate"]) / max(int(dsp["samplesize"]) // 4, 1)
    guard = nominal / 8.0
    g = np.empty((K, S), np.float32)
    faults = 0
    ends = [r[0] for r in runs[1:]] + [K]
    for (a, t_call), b in zip(runs, ends):
        b = min(b, K)
        if a >= b:
            continue
        rate = np.full(S, nominal)
        count = np.zeros(S, np.int64)
        mark = (t_call, times[a, 0])          # the last tick: earliest, latest
        for k in range(a, b):
            if k > a:
                # a tick after frame k - 1 falls after step k - 2 ended
                # (the call, for the run's first frame) and before step
                # k starts
                lo = times[k - 2, 1] if k - 2 >= a else t_call
                hi = times[k, 0]
                if ticks[k]:
                    span_lo = max(lo - mark[1], 1.0) - SLACK_S
                    span_hi = hi - mark[0] + SLACK_S
                    have = count > 0
                    span = 1.0
                    if have.any():
                        with np.errstate(divide="ignore"):
                            implied = count[have] / ups[k, have]
                        span = float(np.clip(np.median(implied), span_lo,
                                             span_hi))
                    rate = np.maximum(count / span, guard)
                    count[:] = 0
                    mark = (lo, hi)
                elif lo - mark[1] >= 1.0 + SLACK_S:
                    faults += 1
            g[k] = (float(dsp["gravity_step"])
                    / np.maximum(rate, 1.0)).astype(np.float32)
            count += mods[k]
    return g, faults

"""Window / weighting curves shared across the DSP and raster stages.

Numerically matches the macro definitions the reference exposes to both
its C transforms and its GLSL shaders (reference:
glava/render.c:660-661 and shaders/glava/util/common.glsl:12-21).
These are host-side (numpy) helpers: windows are static per
configuration, so they are baked into the jitted pipeline as constants
rather than recomputed on device.
"""

from __future__ import annotations

import numpy as np

TWOPI = 6.28318530718
PI = 3.14159265359


def window(t, sz):
    """Hamming-like curve, ``0.53836 - 0.46164*cos(2*pi*t/sz)``.

    This is the *hygienic* reading of the ``window`` macro
    (render.c:660, util/common.glsl:13). NOTE: no call site in the
    reference actually evaluates this curve — every caller passes an
    unparenthesized ``X - 1`` size argument and gets the shifted form
    instead (see :func:`window_shifted` and the macro-expansion note
    there). Kept for the GLSL interpreter (which expands the macro
    textually and reproduces the reference parse on its own) and for
    documentation.
    """
    t = np.asarray(t, dtype=np.float64)
    return 0.53836 - 0.46164 * np.cos(TWOPI * t / sz)


def window_frame(t, sz):
    """0.6/0.4 cosine curve (render.c:661) — hygienic reading; see
    :func:`window_frame_shifted` for what the CPU averaging path
    actually computes."""
    t = np.asarray(t, dtype=np.float64)
    return 0.6 - 0.4 * np.cos(TWOPI * t / sz)


def window_shallow(t, sz):
    """0.7/0.3 cosine curve (util/common.glsl:15). Dead code in the
    reference: average_pass.frag:37 selects it into ``WIN_FUNC`` for
    3-frame averaging but line 41 calls ``window`` directly, so
    ``WIN_FUNC`` is never evaluated. Kept for documentation."""
    t = np.asarray(t, dtype=np.float64)
    return 0.7 - 0.3 * np.cos(TWOPI * t / sz)


# ---------------------------------------------------------------------------
# What the reference's window macros ACTUALLY evaluate to.
#
# ``#define window(t, sz) (0.53836 - (0.46164 * cos(TWOPI * (double) t
# / (double) sz)))`` (render.c:660) is unhygienic: the ``sz`` parameter
# is substituted without parentheses, and every call site passes an
# ``X - 1`` expression —
#
#     render.c:794            window(i, s->sz - 1)
#     render.c:766            window_frame(f, d->avg_frames - 1)
#     average_pass.frag:41    window(I, _AVG_FRAMES - 1)
#
# so ``cos(TWOPI * t / (double) sz)`` expands to
# ``cos(TWOPI * t / (double) X - 1)``: the cast binds tighter than
# ``/`` and the ``- 1`` applies to the WHOLE QUOTIENT. The curve the
# reference evaluates is therefore
#
#     a - b * cos(2*pi*t/X - 1)
#
# — denominator X (not X-1) and a constant -1 *radian* phase shift.
# This was discovered by differential testing against the reference's
# own compiled transforms (tests/test_refdsp_differential.py); the
# hygienic transcriptions everyone would naturally write diverge from
# real glava output by up to ~0.3 per bin. Parity with observed
# behavior is the north-star requirement, so the shifted forms below
# are what the pipeline uses.
# ---------------------------------------------------------------------------


def window_shifted(t, denom):
    """``0.53836 - 0.46164*cos(2*pi*t/denom - 1)`` — the evaluated form
    of every ``window(t, X - 1)`` call site, with ``denom = X``."""
    t = np.asarray(t, dtype=np.float64)
    return 0.53836 - 0.46164 * np.cos(TWOPI * t / denom - 1.0)


def window_frame_shifted(t, denom):
    """``0.6 - 0.4*cos(2*pi*t/denom - 1)`` — the evaluated form of the
    CPU averaging weight ``window_frame(f, avg_frames - 1)``
    (render.c:766), with ``denom = avg_frames``."""
    t = np.asarray(t, dtype=np.float64)
    return 0.6 - 0.4 * np.cos(TWOPI * t / denom - 1.0)


def pcm_window(n: int) -> np.ndarray:
    """The window applied to an ``n``-sample PCM buffer before the FFT.

    Matches the reference loop ``data[i] *= window(i, sz - 1)``
    (render.c:792-795) AS COMPILED: the unhygienic macro expansion
    yields ``0.53836 - 0.46164*cos(2*pi*i/n - 1)`` (denominator ``n``,
    -1 rad phase; see the module note above). Verified against the
    reference's own compiled transform_fft to ~1.7e-5
    (tests/test_refdsp_differential.py::test_fft_differential).
    """
    i = np.arange(n, dtype=np.float64)
    return window_shifted(i, n).astype(np.float32)


def linear(x):
    """Identity weighting curve (util/common.glsl:17)."""
    return np.asarray(x, dtype=np.float64)


def sinusoidal(x):
    """Sine-eased weighting curve (util/common.glsl:19)."""
    x = np.asarray(x, dtype=np.float64)
    return (0.5 * np.sin((PI * x) - (PI / 2))) + 0.5


def circular(x):
    """Circular-arc weighting curve (util/common.glsl:21)."""
    x = np.asarray(x, dtype=np.float64)
    return np.sqrt(np.maximum(1.0 - ((x - 1.0) * (x - 1.0)), 0.0))


ROUND_FORMULAS = {
    "linear": linear,
    "sinusoidal": sinusoidal,
    "circular": circular,
}


def avg_weights(frames: int, windowed: bool, accel: bool = True) -> np.ndarray:
    """Frame-averaging weights for the N-frame history mean, as the
    reference EVALUATES them (shifted macro forms; see module note).

    ``accel=True`` mirrors the default GPU path
    (shaders/glava/util/average_pass.frag): windowing force-disabled at
    ``frames == 2`` (frag:29-31), otherwise the ``window`` curve via
    the unhygienic ``window(I, _AVG_FRAMES - 1)`` call (frag:41) —
    note the ``WIN_FUNC``/``window_shallow`` 3-frame selection at
    frag:33-37 is dead code (line 41 calls ``window`` directly), so
    there is NO 3-frame special case in observed behavior.
    ``accel=False`` mirrors the CPU path (render.c:738-771):
    ``window_frame(f, avg_frames - 1)`` unconditionally when windowed —
    including at 1 and 2 frames (the macro's shifted expansion keeps
    the denominator nonzero even at ``frames == 1``).  Both divide by
    ``frames``.  Verified against the reference's own compiled
    transform_average (tests/test_refdsp_differential.py).

    Returned weights are POSITIONAL, oldest-first — index 0 weights the
    oldest history frame, matching the JAX package's ``transforms.avg_apply``
    history axis. The GPU path's shader indexes by AGE (t0 = newest,
    render.c:2252-2256), so its curve is reversed here; the CPU path's
    ``bufs[f*sz]`` is oldest-first already (render.c:751-766). With the
    true (shifted, asymmetric) curves this ordering is observable —
    the symmetric hygienic transcription used to mask it.
    """
    if frames <= 0:
        raise ValueError("avg frames must be positive")
    f = np.arange(frames, dtype=np.float64)
    if not windowed:
        w = np.ones(frames, dtype=np.float64)
    elif accel:
        if frames == 2:
            w = np.ones(frames, dtype=np.float64)
        else:
            w = window_shifted(f, frames)[::-1]  # age order -> oldest-first
    else:
        w = window_frame_shifted(f, frames)
    return (w / frames).astype(np.float32)

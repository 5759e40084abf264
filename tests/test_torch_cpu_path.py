"""The CPU-path chain (``setaccelfft false``), keyframe interpolation and
the ``smooth`` transform of the port against the JAX package.

Inputs come from a numpy seed and go to both packages. Tolerances (the
JAX suite's): textures within 5e-5 (tests/test_fused.py), the smooth
transform within 1e-5 of the JAX function and of the float64 oracle
(tests/test_ops.py:99) with its NaN-to-0 positions equal, frames under
the golden rule (under 0.2% of pixels more than 2 LSB apart).
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from glava_tpu.config import loader as jloader
from glava_tpu.ops import transforms as jtransforms
from glava_tpu.parallel.batch import BatchedRenderer as JaxBatched
from glava_tpu.pipeline import AudioPipeline as JaxPipeline
from glava_tpu.pipeline import UniformSpec as JaxUniform
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu_torch.config import loader
from glava_tpu_torch.ops import fused, smooth, transforms, windows
from glava_tpu_torch.parallel import BatchedRenderer
from glava_tpu_torch.pipeline import AudioPipeline, UniformSpec
from glava_tpu_torch.renderer import Renderer
from tests import oracles

CHAIN = ("window", "fft", "gravity", "avg")
BARS = [("audio_l", "audio_l", CHAIN), ("audio_r", "audio_r", CHAIN)]
CPU_PATH = ("setaccelfft false", "setprintframes false")

# a user shader module whose one audio uniform takes `window, smooth`
# (stateless: the feed audio through the smooth transform)
SMOOTH_FRAG = """
in vec4 gl_FragCoord;

#request uniform "screen" screen
uniform ivec2 screen;

#request uniform "audio_l" audio_l
#request transform audio_l "window"
#request transform audio_l "smooth"
uniform sampler1D audio_l;

out vec4 fragment;

void main() {
    float v = texture(audio_l, gl_FragCoord.x / screen.x).r * screen.y;
    if (gl_FragCoord.y < v) {
        fragment = vec4(0.2, 0.6, 0.9, 1.0);
        return;
    }
    fragment = vec4(0, 0, 0, 0);
}
"""


def golden_fraction(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float((np.abs(got.astype(np.int16) - want.astype(np.int16)) > 2).mean())


def _loads(reqs, module="bars", **kw):
    kw.update(cli_requests=tuple(reqs), force_module=module)
    return loader.load(**kw), jloader.load(**kw)


# ---------------------------------------------------------------------------
# the CPU-path chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bufsize", [64, 1024, 4096])
def test_cpu_path_textures_match_jax(bufsize):
    """``setaccelfft false`` through both pipelines, bars chain, over 8
    updates of loud audio and then 6 of silence: textures within 5e-5
    after every update. The port takes the unclamped chain (no fused
    launch at any bufsize), and its gravity store goes negative on
    silence as the reference's CPU path does (render.c:730-735)."""
    reqs = CPU_PATH + (f"setbufsize {bufsize}",
                       f"setsamplesize {max(bufsize // 4, 4)}")
    lc, jlc = _loads(reqs)
    port = AudioPipeline(lc.cfg, [UniformSpec(*u) for u in BARS], device="cpu")
    ref = JaxPipeline(jlc.cfg, [JaxUniform(*u) for u in BARS], use_fused=False)
    assert port.route == "chain"
    rng = np.random.default_rng(21)
    sp, sj = port.init_state(), ref.init_state()
    for k in range(14):
        amp = 0.9 if k < 8 else 0.0
        al = (rng.standard_normal(bufsize) * amp).astype(np.float32)
        ar = (rng.standard_normal(bufsize) * amp).astype(np.float32)
        # a fast decay, so that silence takes the store below 0
        sp, tp = port.update(sp, torch.as_tensor(al), torch.as_tensor(ar),
                             gravity_g=0.4)
        sj, tj = ref.update(sj, jnp.asarray(al), jnp.asarray(ar),
                            gravity_g=np.float32(0.4))
        assert tp.keys() == tj.keys()
        for name in tp:
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(tj[name]),
                                       atol=5e-5, err_msg=f"update {k} {name}")
    assert float(sp.gravity.min()) < 0.0
    assert fused.update_route(4096) == "kernel"    # the accel path's route


def test_cpu_path_chain_is_unclamped_fused_plain():
    """The one chain, ``fused.chain_update``, against the JAX package's
    whole chain step on the interleaved layout: its unclamped mode
    against ``fft_update(texture_clamp=False)`` and its clamped mode
    against ``texture_clamp=True``: gravity within 2e-5, the averaged
    texture within 5e-5 (the port's ring average weights frames by age,
    the JAX step shifts its history)."""
    from glava_tpu.ops import windows as jwindows

    n, F, B = 512, 6, 3
    rng = np.random.default_rng(22)
    for clamp in (False, True):
        w_pos = jwindows.avg_weights(F, True, clamp)
        jst = jtransforms.chain_init(n, F, (B,))
        grav = torch.zeros(B, 2, n // 2)
        hist = torch.zeros(B, F, 2, n // 2)
        window = torch.as_tensor(windows.pcm_window(n))
        w_age = torch.as_tensor(fused.age_weights(w_pos))
        ones = torch.ones(B)
        for k in range(9):
            pcm = (rng.standard_normal((B, n)) * (0.9 if k < 5 else 0.0)
                   ).astype(np.float32)
            g = np.float32(0.3)
            jst, jout = jtransforms.fft_update(
                jst, jnp.asarray(pcm), fft_scale=10.2, fft_cutoff=0.3,
                gravity_g=g, avg_weights=jnp.asarray(w_pos),
                texture_clamp=clamp)
            slot = torch.full((B,), k % F, dtype=torch.int32)
            grav, hist, avg = fused.chain_update(
                torch.as_tensor(pcm), grav, hist, slot, ones * 10.2,
                ones * 0.3, ones * g, window, w_age, clamp=clamp)
            inter = torch.stack([grav[:, 0], grav[:, 1]], -1).reshape(B, n)
            np.testing.assert_allclose(inter.numpy(), np.asarray(jst.gravity),
                                       atol=2e-5)
            tex = torch.stack([avg[:, 0], avg[:, 1]], -1).reshape(B, n)
            want = np.asarray(jout) if clamp else np.clip(np.asarray(jout), 0, 1)
            np.testing.assert_allclose(tex.numpy(), want, atol=5e-5)
        assert (float(grav.min()) < 0.0) == (not clamp)


def _staggered(k):
    """Audio arrives every other frame; interp_mod climbs in between."""
    return k % 2 == 0, np.float32(0.35 if k % 2 else 0.7)


@pytest.mark.parametrize("interp", ["on", "off"])
def test_cpu_path_renderer_matches_jax(interp, tmp_path):
    """bars with ``setaccelfft false`` through ``Renderer`` against the
    JAX ``Renderer`` step: with ``setinterpolate`` on the feed blends
    the keyframes and the update runs every frame, off it runs on new
    audio only. 12 frames, golden rule each."""
    reqs = CPU_PATH + ("setgeometry 0 0 96 64", "setbufsize 1024",
                       "setsamplesize 256", f"setinterpolate {interp == 'on'}"
                       .lower())
    lc, jlc = _loads(reqs)
    r, jr = Renderer(lc, device="cpu"), JaxRenderer(jlc)
    assert r.pipeline.route == "chain"
    jstep = jr.jit_step(quantize=True)
    rng = np.random.default_rng(23)
    ps, js = r.init_state(), jr.init_state()
    drawn = False
    for k in range(12):
        snap = (rng.standard_normal((2, 1024)) * 0.4).astype(np.float32)
        mod, im = _staggered(k)
        ps, got = r.step_u8(ps, snap, mod, 0.1, float(im), 0.05)
        js, want = jstep(js, jnp.asarray(snap), mod, np.float32(0.1), im,
                         np.float32(0.05), {})
        frac = golden_fraction(got.numpy(), want)
        assert frac < 0.002, f"frame {k}: {frac:.4%}"
        drawn |= bool((got[..., 3] > 0).any())
    assert drawn


@pytest.mark.parametrize("interp", ["on", "off"])
def test_cpu_path_fleet_matches_jax(interp):
    """The same through ``BatchedRenderer`` (S = 3 streams on staggered
    clocks, per-stream ``interp_mod``): the JAX fleet interpolates the
    feed, then gates the advance by ``modified``."""
    reqs = CPU_PATH + ("setgeometry 0 0 96 64", "setbufsize 1024",
                       "setsamplesize 256", f"setinterpolate {interp == 'on'}"
                       .lower())
    lc, jlc = _loads(reqs)
    n = 3
    br, jbr = BatchedRenderer(lc, n, device="cpu"), JaxBatched(jlc, n)
    jstep = jax.jit(functools.partial(jbr.step, quantize=True))
    rng = np.random.default_rng(24)
    ps, js = br.init_state(), jbr.init_state()
    for k in range(10):
        audio = (rng.standard_normal((n, 2, 1024)) * 0.4).astype(np.float32)
        mod = np.array([k % (s + 1) == 0 for s in range(n)])
        im = rng.uniform(0.1, 1.3, n).astype(np.float32)
        t, g = np.zeros(n, np.float32), np.full(n, 0.05, np.float32)
        ps, got = br.step(ps, audio, mod, t, im, g, quantize=True)
        js, want = jstep(js, *(jnp.asarray(a) for a in (audio, mod, t, im, g)),
                         {})
        for s in range(n):
            frac = golden_fraction(got[s].numpy(), np.asarray(want[s]))
            assert frac < 0.002, f"frame {k} stream {s}: {frac:.4%}"
    kp = br.renderer.pipeline.textures_from(ps.chains, ps.key_end[:, 0],
                                            ps.key_end[:, 1])
    kj = jbr.renderer.pipeline.textures_from(js.chains, js.key_end[:, 0],
                                             js.key_end[:, 1])
    for name in kp:
        np.testing.assert_allclose(kp[name].numpy(), np.asarray(kj[name]),
                                   atol=5e-5)


def test_interpolate_matches_jax():
    """``transforms.interpolate(start, end, uratio * kcounter)`` against
    the JAX package's ``interpolate(start, end, uratio, kcounter)``,
    the blend ``min(mod, 1)`` past 1 included; within 1e-7."""
    rng = np.random.default_rng(25)
    a, b = (rng.standard_normal((2, 64)).astype(np.float32) for _ in range(2))
    for uratio, k in ((0.3, 1), (0.3, 2), (0.5, 4)):
        got = transforms.interpolate(torch.as_tensor(a), torch.as_tensor(b),
                                     uratio * k)
        want = jtransforms.interpolate(jnp.asarray(a), jnp.asarray(b), uratio, k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


def test_interpolate_per_stream_matches_jax_fleet_blend():
    """One ``mod`` a stream, (S,) against (S, 2, n) keyframes, as the
    fleet blends them: against the JAX fleet's own expression
    (glava_tpu/parallel/batch.py), within 1e-7."""
    rng = np.random.default_rng(26)
    a, b = (rng.standard_normal((4, 2, 32)).astype(np.float32)
            for _ in range(2))
    mod = np.float32([0.0, 0.35, 1.0, 1.6])
    got = transforms.interpolate(torch.as_tensor(a), torch.as_tensor(b), mod)
    im3 = jnp.minimum(jnp.asarray(mod), 1.0)[:, None, None]
    want = jnp.asarray(a) + (jnp.asarray(b) - jnp.asarray(a)) * im3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    # a mod past 1 blends as 1
    np.testing.assert_array_equal(
        got[3].numpy(), transforms.interpolate(torch.as_tensor(a[3]),
                                               torch.as_tensor(b[3]), 1.0))


# ---------------------------------------------------------------------------
# the smooth transform
# ---------------------------------------------------------------------------

# (sz, ratio, distance): the default 4/0.01, the widest window 0.5, the
# whole row (ratio 1) and a ratio that leaves a partial tail
SMOOTH_CASES = [(256, 4.0, 0.01), (256, 1.0, 0.5), (1024, 4.0, 0.5),
                (512, 1.0, 0.01), (300, 3.0, 0.2)]


def _smooth_rows(sz, seed, rows=3):
    """Rows in [-1, 1] with about 20% exact zeros; row 1 opens on a run
    of zeros (empty windows: NaNs that propagate)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (rows, sz)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.2] = 0.0
    x[1, :40] = 0.0
    return x


@pytest.mark.parametrize("sz,ratio,distance", SMOOTH_CASES)
def test_smooth_plain_matches_jax_and_oracle(sz, ratio, distance):
    """``smooth_transform_plain`` against the JAX ``lax.scan`` and the
    float64 oracle: within 1e-5, the NaN-to-0 positions equal."""
    x = _smooth_rows(sz, 27)
    got = smooth.smooth_transform_plain(torch.as_tensor(x), ratio, distance).numpy()
    want = np.asarray(jtransforms.smooth_transform(jnp.asarray(x), ratio, distance))
    oracle = np.stack([oracles.smooth_transform(r, ratio, distance) for r in x])
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, oracle, atol=1e-5)
    nan_want = np.stack([_nan_positions(r, ratio, distance) for r in x])
    assert np.array_equal(got == 0, (want == 0))
    assert (got[nan_want] == 0).all() and nan_want[1, :40].any()
    # the dispatcher takes the plain version for a CPU tensor
    assert torch.equal(smooth.smooth_transform(torch.as_tensor(x), ratio, distance),
                       torch.as_tensor(got))


def _nan_positions(row, ratio, distance):
    """Where the oracle's walk produces NaN (before the final 0)."""
    b = np.asarray(row, np.float64).copy()
    bounds = smooth.smooth_bounds(len(b), ratio, distance)
    out = np.zeros(len(b), bool)
    for t, (lo, hi) in enumerate(bounds):
        win = b[lo:hi + 1]
        hit = win != 0
        b[t] = win[hit].sum() / hit.sum() if hit.any() else np.nan
        out[t] = np.isnan(b[t])
    return out


def _stats(v: np.ndarray) -> np.ndarray:
    """Per entry: the finite value in float64, nonzero, NaN, +inf, -inf
    (the kernel's prefix statistics; the four counts as float64, exact
    at these sizes)."""
    v = np.asarray(v, np.float32)
    return np.stack([np.where(np.isfinite(v), v, 0).astype(np.float64),
                     v != 0, np.isnan(v), v == np.inf, v == -np.inf],
                    -1).astype(np.float64)


def _mean(c) -> np.float32:
    if c[1] == 0 or c[2] or (c[3] and c[4]):
        return np.float32(np.nan)
    if c[3] or c[4]:
        return np.float32(np.inf if c[3] else -np.inf)
    return np.float32(c[0]) / np.float32(c[1])


def _chunk_prefix(st: np.ndarray) -> np.ndarray:
    """(n + 1, 5): the prefix of ``st``'s rows as the kernel's block
    scan sums them (256 chunks, each chunk's entries in turn after its
    exclusive start)."""
    n = len(st)
    per = max(-(-n // 256), 1)
    chunks = [st[c * per:(c + 1) * per] for c in range(256)]
    P = np.zeros((n + 1, 5))
    start = np.zeros(5)
    for c, ch in enumerate(chunks):
        run = start.copy()
        for i, e in enumerate(ch):
            P[c * per + i] = run
            run = run + e
        if len(ch) and c * per + len(ch) == n:
            P[n] = run
        start = start + ch.sum(0)
    return P


def _fma(a: float, b: float, c: float) -> float:
    """a * b + c rounded once to float64, as the card's fma."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _fmaf(a, b, c) -> np.float32:
    """The card's float32 fma of float32 operands (rounded through
    float64: the same but for rare ties)."""
    return np.float32(_fma(float(np.float32(a)), float(np.float32(b)),
                           float(np.float32(c))))


def smooth_scan_model(x: np.ndarray, ratio: float, distance: float,
                      exact_from: int | None = None):
    """numpy transcription of csrc/smooth_scan.cu; returns the output
    and, per row, the bin from which its exact walk ran (asz: none).

    The fast walk: from P, the prefix statistics of the input row, each
    bin's count c = (t - lo) + nonzero inputs in [t, hi], its original
    sum R and its NaN class; its window sum is a1 v_{t-1} + a2 v_{t-2} +
    T + R, a1 = [lo <= t - 1], a2 = [lo <= t - 2], T the float64 sum of
    the bins [lo, t - 3] (gaining bin t - 3 and dropping bin lo_{t-1} as
    the window moves), and v_t = fmaf(v_{t-1}, a1 / c, fmaf(v_{t-2},
    a2 / c, float32((T + R) / c))) in float32; NaN bins poison through
    the last NaN bin (their chain value 0). After the walk, the first
    bin whose window sum (S[t] - S[lo]) + R in float64 is 0 (S the
    prefix of the chain's values), or whose value is 0 (not NaN), gives
    0, and the exact walk takes
    the rest of the row from the bin after it, or from the first window
    that holds an input +-inf, or from bin 1 where lo jumps by 2
    (distance 0): S rebuilt as prefix statistics of the bins done, each
    window (S[t] - S[lo]) + (P[hi + 1] - P[t]), its mean a float32
    division."""
    sz = x.shape[-1]
    b = smooth.smooth_bounds(sz, ratio, distance)
    asz = len(b)
    out = np.array(x, np.float32).copy()
    handoffs = []
    for row in out.reshape(-1, sz):
        P = _chunk_prefix(_stats(row))
        ys = np.zeros(asz, np.float32)
        ys[0] = np.nan
        inf = np.flatnonzero(np.isinf(row[1:]))
        first_inf = 1 + inf[0] if len(inf) else sz
        past = np.flatnonzero(b[1:, 1] >= first_inf)
        if exact_from is None:
            # the fast walk where lo grows by 0 or 1 a bin
            step = np.diff(b[1:, 0])
            exact_from = asz if np.all((step == 0) | (step == 1)) else 1
        end = min(1 + past[0] if len(past) else asz, max(exact_from, 1))
        vs = np.zeros(asz, np.float32)   # the chain's values (0: NaN)
        T = 0.0                           # the window's bins [lo, t - 3]
        lastnan = 0
        for t in range(1, end):
            lo, hi = b[t]
            c = (t - lo) + P[hi + 1, 1] - P[t, 1]
            r = P[hi + 1, 0] - P[t, 0]
            iv = 1.0 / c if c > 0 else 0.0
            poisoned = P[hi + 1, 2] > P[t, 2] or c == 0 or lastnan >= lo
            # T gains bin t - 3 and drops bin lo_{t-1} as the window moves
            lop = b[t - 1, 0]
            T += (float(vs[t - 3]) if lo <= t - 3 else 0.0) - (
                float(vs[lop]) if t >= 2 and lop < lo and lop <= t - 4 else 0.0)
            ivf = np.float32(0.0 if poisoned else iv)
            gf = np.float32(0.0 if poisoned else (T + r) * iv)
            inner = _fmaf(vs[t - 2] if t >= 2 else 0.0,
                          ivf if lo <= t - 2 else 0.0, gf)
            v = _fmaf(vs[t - 1], ivf if lo <= t - 1 else 0.0, inner)
            ys[t] = np.nan if poisoned else v
            vs[t] = v
            lastnan = t if poisoned else lastnan
        # the first bin whose exact window sum is 0 or whose value is 0
        S = np.concatenate([[0.0], np.cumsum(vs[:end], dtype=np.float64)])
        zero = asz
        for t in range(1, end):
            lo = b[t, 0]
            w = (S[t] - S[lo]) + (P[b[t, 1] + 1, 0] - P[t, 0])
            if not np.isnan(ys[t]) and (w == 0 or ys[t] == 0):
                zero = t
                ys[t] = 0.0
                break
        h = min(end, zero + 1)
        if h < asz:
            SS = np.zeros((asz + 1, 5))
            SS[:h + 1] = _chunk_prefix(_stats(ys[:h]))
            for t in range(h, asz):
                lo, hi = b[t]
                ys[t] = _mean((SS[t] - SS[lo]) + (P[hi + 1] - P[t]))
                SS[t + 1] = SS[t] + _stats(ys[t:t + 1])[0]
        handoffs.append(h)
        row[:asz] = ys
    return (np.nan_to_num(out, nan=0.0, posinf=np.inf, neginf=-np.inf),
            np.array(handoffs))


@pytest.mark.parametrize("sz,ratio,distance", SMOOTH_CASES)
def test_smooth_kernel_walk_matches_plain(sz, ratio, distance):
    """The kernel's arithmetic (its two walks, transcribed in numpy)
    against the plain version: within 1e-5, zeros equal; with an inf in
    a row too (that row's exact walk from its first window holding the
    inf), and with every row on the exact walk from bin 1."""
    x = _smooth_rows(sz, 28)
    x[2, 5] = np.inf
    want = smooth.smooth_transform_plain(torch.as_tensor(x), ratio, distance).numpy()
    asz = smooth.smooth_bounds(sz, ratio, distance).shape[0]
    for exact_from in (None, 1):
        got, handoffs = smooth_scan_model(x, ratio, distance, exact_from)
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert np.array_equal(got == 0, want == 0)
        if exact_from is None:
            assert handoffs[0] == handoffs[1] == asz and handoffs[2] <= 5
        else:
            assert (handoffs == 1).all()


# rows of 512 (ratio 4, d 0.01: 128 bins) per case, row 0 forcing one of
# the kernel's branches, row 1 as _smooth_rows makes it: case -> the bin
# row 0's exact walk starts from (None: none)
SMOOTH_BRANCHES = {
    # bin 1's window [1, 2] sums to 0; bin 2's [1, 3] holds a smoothed 0
    "cancellation": 2,
    "posinf": "inf",
    "neginf": "inf",
    "nan": None,
    "silent": None,
    # distance 0: lo jumps by 2 somewhere, so both rows walk exactly
    "distance0": 1,
}


def _branch_row(case: str) -> np.ndarray:
    x = _smooth_rows(512, 33, rows=2)
    if case == "cancellation":
        x[0, 1], x[0, 2] = 0.5, -0.5
    elif case == "posinf":
        x[0, 60] = np.inf
    elif case == "neginf":
        x[0, 60] = -np.inf
    elif case == "nan":
        x[0, 30] = np.nan
    elif case == "silent":
        x[:] = 0.0
    return x


@pytest.mark.parametrize("case", list(SMOOTH_BRANCHES))
def test_smooth_kernel_walk_branches(case):
    """Each branch of the kernel's walks, transcribed: an exact
    cancellation hands the row to the exact walk after the zero bin, an
    input +-inf at the first window that holds it, a NaN input stays on
    the fast walk (poisoning its windows), a silent row gives all 0, and
    at distance 0 (lo jumps by 2) every row walks exactly from bin 1;
    within 1e-5 of the plain version, zeros equal."""
    x = _branch_row(case)
    d = 0.0 if case == "distance0" else 0.01
    got, handoffs = smooth_scan_model(x, 4.0, d)
    want = smooth.smooth_transform_plain(torch.as_tensor(x), 4.0, d).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.array_equal(got == 0, want == 0)
    b = smooth.smooth_bounds(512, 4.0, d)
    expect = SMOOTH_BRANCHES[case]
    if expect == "inf":
        # the inf from the first window holding it to the last bin (each
        # window holds the bin before it)
        expect = int(np.flatnonzero(b[:, 1] >= 60)[0])
        assert (got[0, expect:len(b)] == x[0, 60]).all()
        assert np.isfinite(got[0, :expect]).all()
    assert handoffs[0] == (len(b) if expect is None else expect)
    assert handoffs[1] == (1 if case == "distance0" else len(b))
    if case == "cancellation":
        assert got[0, 1] == 0 and want[0, 1] == 0
    if case == "silent":
        assert (got == 0).all()
    if case == "nan":
        # NaN -> 0 from the first window holding x[30] to the last bin
        t0 = int(np.flatnonzero(b[:, 1] >= 30)[0])
        assert (got[0, t0:len(b)] == 0).all() and (got[0, 1:t0] != 0).all()


@pytest.mark.parametrize("distance,fast", [(0.01, True), (0.5, True),
                                            (0.0, False)])
def test_smooth_fast_walk_takes_windows_whose_lo_grows_by_one(distance, fast):
    """The kernel's fast walk drops each bin from its running window sum
    once, in order, so it needs lo to grow by 0 or 1 a bin; at distance
    0 (lo = t up to rounding) it jumps by 2, and every row walks exactly
    (``_bounds``'s flag, the kernel's exact_from 1)."""
    bounds, got = smooth._bounds(4096, 4.0, distance, torch.device("cpu"))
    step = np.diff(bounds.numpy()[1:, 0])
    assert got == fast == bool(np.all((step == 0) | (step == 1)))


@pytest.mark.parametrize("ratio", [4.0, 1.0])
def test_smooth_tables_fit_shared_memory_at_4096(ratio):
    """The shipped bufsize's tables (either walk's) lie in shared memory
    at any ratio; sz 65536's take the device scratch route."""
    asz = smooth.smooth_bounds(4096, ratio, 0.01).shape[0]
    assert smooth.table_bytes(4096, asz) <= smooth.STAGED_MAX
    assert smooth.table_bytes(65536, -(-65536 // int(ratio))) > smooth.STAGED_MAX


def test_smooth_bounds_are_the_jax_mask():
    from glava_tpu.ops.transforms import _smooth_mask

    for sz, ratio, distance in SMOOTH_CASES:
        mask = _smooth_mask(sz, ratio, distance)
        b = smooth.smooth_bounds(sz, ratio, distance)
        rebuilt = np.zeros_like(mask)
        for t, (lo, hi) in enumerate(b):
            rebuilt[t, lo:hi + 1] = 1.0
        assert np.array_equal(rebuilt, mask)


@pytest.mark.parametrize("chain", [("window", "smooth"), ("wrange", "smooth"),
                                   ("window", "fft", "smooth")])
def test_smooth_uniform_matches_jax(chain):
    """A ``smooth`` uniform beside the bars chain: stateless chains run
    the transform on the feed audio in order; an fft chain ignores it,
    as the JAX package does. Textures within 5e-5 over 4 updates."""
    uniforms = BARS + [("extra", "audio_l", chain)]
    lc, jlc = _loads(("setbufsize 1024", "setsamplesize 256",
                      "setprintframes false"))
    port = AudioPipeline(lc.cfg, [UniformSpec(*u) for u in uniforms],
                         device="cpu")
    ref = JaxPipeline(jlc.cfg, [JaxUniform(*u) for u in uniforms],
                      use_fused=False)
    rng = np.random.default_rng(29)
    sp, sj = port.init_state(), ref.init_state()
    for _ in range(4):
        al = (rng.standard_normal(1024) * 0.4).astype(np.float32)
        al[rng.uniform(size=1024) < 0.2] = 0.0
        ar = (rng.standard_normal(1024) * 0.4).astype(np.float32)
        sp, tp = port.update(sp, torch.as_tensor(al), torch.as_tensor(ar))
        sj, tj = ref.update(sj, jnp.asarray(al), jnp.asarray(ar))
        for name in tp:
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(tj[name]),
                                       atol=5e-5, err_msg=name)
    assert ("fft" in chain) == ("extra" in [u.name for u in port.fft_uniforms])


def test_smooth_shader_module_matches_jax(tmp_path):
    """A user shader module with a ``window, smooth`` uniform through
    ``Renderer`` against the JAX ``Renderer``: golden rule, 4 frames."""
    d = tmp_path / "cfg"
    (d / "smoothy").mkdir(parents=True)
    (d / "smoothy" / "1.frag").write_text(SMOOTH_FRAG)
    reqs = ("setgeometry 0 0 96 64", "setbufsize 1024", "setsamplesize 256",
            "setprintframes false")
    lc, jlc = _loads(reqs, module="smoothy", user_dir=d)
    r, jr = Renderer(lc, device="cpu"), JaxRenderer(jlc)
    assert [u.transforms for u in r.uniforms] == [("window", "smooth")]
    jstep = jr.jit_step(quantize=True)
    rng = np.random.default_rng(30)
    t = np.arange(1024) / 22050.0
    ps, js = r.init_state(), jr.init_state()
    for k in range(4):
        tone = 0.6 * np.sin(2 * np.pi * (200.0 + 50 * k) * t)
        snap = np.stack([tone, tone]).astype(np.float32)
        snap[:, rng.uniform(size=1024) < 0.2] = 0.0
        ps, got = r.step_u8(ps, snap, True, 0.1, 1.0, 0.05)
        js, want = jstep(js, jnp.asarray(snap), True, np.float32(0.1),
                         np.float32(1.0), np.float32(0.05), {})
        assert golden_fraction(got.numpy(), want) < 0.002
    assert (got[..., 3] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SMOOTH_BRANCHES))
def test_smooth_kernel_branches_on_the_card(case):
    """Each branch case through csrc/smooth_scan.cu against its plain
    version on the card: within 1e-5, zeros equal, row 0 on the walk the
    numpy model takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    x = _branch_row(case)
    d = 0.0 if case == "distance0" else 0.01
    _, handoffs = smooth_scan_model(x, 4.0, d)
    asz = smooth.smooth_bounds(512, 4.0, d).shape[0]
    smooth.reset_rows_by_walk()
    got = smooth.smooth_transform(torch.as_tensor(x, device="cuda"), 4.0, d)
    want = smooth.smooth_transform_plain(torch.as_tensor(x), 4.0, d)
    assert torch.equal(got.cpu() == 0, want == 0)
    # the same +-inf, the finite values within 1e-5
    torch.testing.assert_close(got.cpu(), want, rtol=0.0, atol=1e-5)
    exact = int((handoffs < asz).sum())
    assert smooth.rows_by_walk() == {"fast": 2 - exact, "exact": exact}


@pytest.mark.cuda
@pytest.mark.parametrize("sz,ratio,distance", [(4096, 4.0, 0.01), (4096, 1.0, 0.5),
                                               (65536, 4.0, 0.01)])
def test_smooth_kernel_meets_plain_on_the_card(sz, ratio, distance):
    """csrc/smooth_scan.cu against its plain version on the card: within
    1e-5, zeros equal, one launch a call (prefix tables in shared
    memory and, at 65536, in a device scratch buffer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    x = torch.as_tensor(_smooth_rows(sz, 31, rows=2), device="cuda")
    n0 = smooth.launches
    got = smooth.smooth_transform(x, ratio, distance)
    torch.cuda.synchronize()
    assert smooth.launches == n0 + 1
    want = smooth.smooth_transform_plain(x, ratio, distance)
    assert torch.equal(got == 0, want == 0)
    assert float((got - want).abs().max()) <= 1e-5

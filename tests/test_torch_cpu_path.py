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


def smooth_scan_model(x: np.ndarray, ratio: float, distance: float) -> np.ndarray:
    """numpy transcription of csrc/smooth_scan.cu: P, the prefix
    statistics of the input row, summed as the kernel's block scan sums
    them (256 chunks, each chunk's entries in turn after its exclusive
    start); S, those of the smoothed bins, one entry a bin; bin t's
    window is (S[t] - S[lo]) + (P[hi + 1] - P[t]), its mean in float32."""
    sz = x.shape[-1]
    b = smooth.smooth_bounds(sz, ratio, distance)
    out = np.array(x, np.float32).copy()
    per = -(-sz // 256)
    for row in out.reshape(-1, sz):
        st = _stats(row)
        starts = np.zeros((256, 5))
        chunks = [st[c * per:(c + 1) * per] for c in range(256)]
        for c in range(1, 256):
            starts[c] = starts[c - 1] + chunks[c - 1].sum(0)
        P = np.zeros((sz + 1, 5))
        for c, ch in enumerate(chunks):
            run = starts[c].copy()
            for i, e in enumerate(ch):
                P[c * per + i] = run
                run = run + e
            if len(ch) and c * per + len(ch) == sz:
                P[sz] = run
        S = np.zeros((len(b) + 1, 5))
        row[0] = np.nan
        S[1] = _stats(row[:1])[0]
        for t in range(1, len(b)):
            lo, hi = b[t]
            row[t] = _mean((S[t] - S[lo]) + (P[hi + 1] - P[t]))
            S[t + 1] = S[t] + _stats(row[t:t + 1])[0]
    return np.nan_to_num(out, nan=0.0, posinf=np.inf, neginf=-np.inf)


@pytest.mark.parametrize("sz,ratio,distance", SMOOTH_CASES)
def test_smooth_kernel_walk_matches_plain(sz, ratio, distance):
    """The kernel's arithmetic (its prefix-statistics walk, transcribed
    in numpy) against the plain version: within 1e-5, zeros equal; with an
    inf in a row too."""
    x = _smooth_rows(sz, 28)
    x[2, 5] = np.inf
    got = smooth_scan_model(x, ratio, distance)
    want = smooth.smooth_transform_plain(torch.as_tensor(x), ratio, distance).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.array_equal(got == 0, want == 0)


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

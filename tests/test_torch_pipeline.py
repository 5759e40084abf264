"""The port's AudioPipeline, spectrum and presmooth against the JAX package.

Inputs come from a numpy seed and are fed to both packages. Tolerances:
5e-5 on textures and 2e-5 on spectra (the JAX suite's own, from
tests/test_fused.py), and bit-for-bit equality for the baked resample
operators, the port's only "weights".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from glava_tpu.config import loader as jloader
from glava_tpu.ops import fft as jfft
from glava_tpu.ops import smoothing as jsmoothing
from glava_tpu.pipeline import AudioPipeline as JaxPipeline
from glava_tpu.pipeline import UniformSpec as JaxUniform
from glava_tpu_torch.config import loader
from glava_tpu_torch.config.state import RenderConfig
from glava_tpu_torch.ops import fft, smoothing
from glava_tpu_torch.pipeline import (
    AudioPipeline, UniformSpec, clone_state, frame_windows,
)
from glava_tpu.pipeline import frame_windows as jframe_windows

CHAIN = ("window", "fft", "gravity", "avg")
BARS = [("audio_l", "audio_l", CHAIN), ("audio_r", "audio_r", CHAIN)]


def _load(bufsize=1024, samplesize=256):
    reqs = (f"setbufsize {bufsize}", f"setsamplesize {samplesize}",
            "setprintframes false")
    return (loader.load(cli_requests=reqs, force_module="bars"),
            jloader.load(cli_requests=reqs, force_module="bars"))


@pytest.mark.parametrize("bufsize", [256, 1024, 4096])
def test_textures_match_jax_unfused(bufsize):
    """7 updates of fresh audio through both pipelines, bars chain;
    textures within 5e-5 after every update."""
    lc, jlc = _load(bufsize, bufsize // 4)
    port = AudioPipeline(lc.cfg, [UniformSpec(*u) for u in BARS], device="cpu")
    ref = JaxPipeline(jlc.cfg, [JaxUniform(*u) for u in BARS], use_fused=False)
    rng = np.random.default_rng(2)
    sp, sj = port.init_state(), ref.init_state()
    for _ in range(7):
        al = (rng.standard_normal(bufsize) * 0.3).astype(np.float32)
        ar = (rng.standard_normal(bufsize) * 0.3).astype(np.float32)
        sp, tp = port.update(sp, torch.as_tensor(al), torch.as_tensor(ar))
        sj, tj = ref.update(sj, jnp.asarray(al), jnp.asarray(ar))
        assert tp.keys() == tj.keys()
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(tj[k]),
                                       atol=5e-5)


CHAINS = {
    "window_fft": ("window", "fft"),
    "window_fft_avg": ("window", "fft", "avg"),
    "fft_gravity": ("fft", "gravity"),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_any_fft_chain_matches_jax_unfused(chain):
    """A uniform whose chain holds ``fft`` but is not the standard one
    (tests/test_walk_fuzz.py's ``window, fft``) takes the same spectrum
    -> gravity -> history -> average update as in the JAX package;
    beside it a stateless ``wrange`` uniform. Textures within 5e-5 over
    8 updates."""
    uniforms = [("audio_l", "audio_l", CHAINS[chain]),
                ("audio_r", "audio_r", ("window", "wrange"))]
    lc, jlc = _load()
    port = AudioPipeline(lc.cfg, [UniformSpec(*u) for u in uniforms],
                         device="cpu")
    ref = JaxPipeline(jlc.cfg, [JaxUniform(*u) for u in uniforms],
                      use_fused=False)
    assert [u.name for u in port.fft_uniforms] == ["audio_l"]
    rng = np.random.default_rng(12)
    sp, sj = port.init_state(), ref.init_state()
    for _ in range(8):
        al = (rng.standard_normal(1024) * 0.3).astype(np.float32)
        ar = (rng.standard_normal(1024) * 0.3).astype(np.float32)
        sp, tp = port.update(sp, torch.as_tensor(al), torch.as_tensor(ar))
        sj, tj = ref.update(sj, jnp.asarray(al), jnp.asarray(ar))
        assert tp.keys() == tj.keys()
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(tj[k]),
                                       atol=5e-5)


def test_batched_textures_and_per_stream_params():
    """Streams ride a leading batch axis with per-stream parameters
    (rows s * U + u), matching the JAX pipeline's batched update."""
    lc, jlc = _load()
    port = AudioPipeline(lc.cfg, [UniformSpec(*u) for u in BARS], device="cpu")
    ref = JaxPipeline(jlc.cfg, [JaxUniform(*u) for u in BARS], use_fused=False)
    S = 3
    rng = np.random.default_rng(4)
    sp, sj = port.init_state((S,)), ref.init_state((S,))
    scale = np.asarray([5.0, 10.2, 15.0], np.float32)
    g = np.asarray([0.01, 0.05, 0.2], np.float32)
    for _ in range(4):
        al = (rng.standard_normal((S, 1024)) * 0.3).astype(np.float32)
        ar = (rng.standard_normal((S, 1024)) * 0.3).astype(np.float32)
        sp, tp = port.update(sp, torch.as_tensor(al), torch.as_tensor(ar),
                             fft_scale=torch.as_tensor(scale),
                             gravity_g=torch.as_tensor(g))
        sj, tj = ref.update(sj, jnp.asarray(al), jnp.asarray(ar),
                            fft_scale=jnp.asarray(scale),
                            gravity_g=jnp.asarray(g))
    for k in tp:
        assert tp[k].shape == (S, 1024)
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(tj[k]), atol=5e-5)


def test_select_updated_keeps_carried_rows():
    """Per-stream gating: rows of unmodified streams keep their old
    state, like the JAX pipeline's select_updated."""
    lc, _ = _load()
    port = AudioPipeline(lc.cfg, [UniformSpec(*u) for u in BARS], device="cpu")
    S = 3
    rng = np.random.default_rng(5)
    state = port.init_state((S,))
    audio = torch.as_tensor((rng.standard_normal((2, S, 1024)) * 0.3)
                            .astype(np.float32))
    state = port.advance(state, audio[0], audio[1])
    old = clone_state(state)
    new = port.advance(state, audio[1], audio[0])
    mask = torch.tensor([True, False, True])
    sel = port.select_updated(new, old, mask)
    rows = mask.repeat_interleave(2)
    for got, n, o in zip(sel, new, old):
        assert torch.equal(got[rows], n[rows])
        assert torch.equal(got[~rows], o[~rows])


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_packed_spectrum_matches_jax(n):
    """Per-row boosts up to the shipped fft_scale 10.2. (The JAX package
    runs its DFT as float32 matmuls; at fft_scale 20, or at n = 16384,
    its own rounding times the boost passes 2e-5. The port's FFT runs
    in float64; see the float64 numpy reference below.)"""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n)) * 0.3).astype(np.float32)
    scale = np.asarray([5.0, 10.2, 1.0], np.float32)
    cut = np.asarray([0.0, 0.3, 0.5], np.float32)
    got = fft.packed_spectrum(torch.as_tensor(x), torch.as_tensor(scale),
                              torch.as_tensor(cut))
    want = jfft.packed_spectrum(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(cut))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("n", [256, 4096, 16384])
def test_packed_spectrum_matches_float64_reference(n):
    """Against the packed-pair DFT, log-magnitude and boost in numpy
    float64, with boosts up to fft_scale 20, at 2e-5."""
    rng = np.random.default_rng(n + 1)
    x = (rng.standard_normal((3, n)) * 0.3).astype(np.float32)
    scale = np.asarray([5.0, 10.2, 20.0], np.float32)
    cut = np.asarray([0.0, 0.3, 0.5], np.float32)
    spec = np.fft.fft(x[:, 0::2].astype(np.float64) + 1j * x[:, 1::2])
    inter = np.stack([spec.real, spec.imag], axis=-1).reshape(3, n)
    j = np.arange(n) / n
    want = (np.log(np.abs(inter) + 1.0) / 3.0
            * np.maximum(j * scale[:, None] + (1.0 - cut[:, None]), 1.0))
    got = fft.packed_spectrum(torch.as_tensor(x), torch.as_tensor(scale),
                              torch.as_tensor(cut))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def _assert_ops_equal(got, want):
    assert got.mode == want.mode
    for f in ("matrix", "idx", "w"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("banded", "banded_re", "banded_im"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a.starts, b.starts), f
            assert a.blocks.dtype == b.blocks.dtype
            assert np.array_equal(a.blocks, b.blocks), f
            assert a.n_out == b.n_out


@pytest.mark.parametrize("sz", [256, 1024, 4096, 8192])
def test_presmooth_op_is_bit_identical(sz):
    """The baked smooth-pass operator (dense at small sizes, block-banded
    from 4096) equals the JAX package's exactly."""
    p = smoothing.SmoothParams()
    jp = jsmoothing.SmoothParams()
    _assert_ops_equal(smoothing.presmooth_op(sz, p), jsmoothing.presmooth_op(sz, jp))


@pytest.mark.parametrize("mode,banded", [
    ("average", None), ("average", True), ("maximum", None), ("hybrid", None),
])
def test_resample_apply_matches_jax(mode, banded):
    """Dense, banded and max/hybrid resamples, on interleaved textures
    and straight off the complex planes."""
    sz = 512
    pos = np.linspace(0.0, 1.0, 77)
    p = smoothing.SmoothParams(sample_mode=mode)
    jp = jsmoothing.SmoothParams(sample_mode=mode)
    op = smoothing.build_resample(sz, pos, p, banded=banded)
    jop = jsmoothing.build_resample(sz, pos, jp, banded=banded)
    _assert_ops_equal(op, jop)
    tex = np.random.default_rng(6).uniform(0, 1, (2, sz)).astype(np.float32)
    dev = op.on("cpu")
    np.testing.assert_allclose(dev(torch.as_tensor(tex)).numpy(),
                               np.asarray(jop(jnp.asarray(tex))), atol=2e-6)
    re, im = tex[:, 0::2].copy(), tex[:, 1::2].copy()
    np.testing.assert_allclose(
        dev.apply_planes(torch.as_tensor(re), torch.as_tensor(im)).numpy(),
        np.asarray(jop.apply_planes(jnp.asarray(re), jnp.asarray(im))),
        atol=2e-6)


@pytest.mark.parametrize("fn", ["fft_chain", "wrange", "decimate"])
def test_chain_pieces_match_jax(fn):
    """The windowed fft transform (2e-5, spectrum), wrange and the
    setbufscale decimation (exact float32 arithmetic, 1e-7)."""
    from glava_tpu.ops import transforms as jt
    from glava_tpu_torch.ops import transforms as tt

    x = (np.random.default_rng(8).standard_normal((2, 1024)) * 0.3).astype(np.float32)
    if fn == "fft_chain":
        got = tt.fft_chain(torch.as_tensor(x), 10.2, 0.3)
        want = jt.fft_chain(jnp.asarray(x), 10.2, 0.3)
        tol = 2e-5
    elif fn == "wrange":
        got, want, tol = tt.wrange(torch.as_tensor(x)), jt.wrange(jnp.asarray(x)), 0
    else:
        got = tt.decimate(torch.as_tensor(x), 3)
        want = jt.decimate(jnp.asarray(x), 3)
        tol = 1e-7
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


def test_frame_windows_match_jax():
    pcm = np.random.default_rng(7).standard_normal(5000).astype(np.float32)
    assert np.array_equal(frame_windows(pcm, 1024, 256),
                          jframe_windows(pcm, 1024, 256))


WAVE = ("wave_l", "audio_l", ("window", "wrange"))


@pytest.mark.parametrize("uniforms", [[WAVE], BARS + [WAVE]],
                         ids=["stateless", "mixed"])
def test_stateless_chain_textures_match_jax(uniforms):
    """A uniform with no fft (wave's ``window, wrange``) is the feed
    audio in [0, 1], beside fft uniforms or alone; alone it keeps a
    state of no rows and runs no update."""
    lc, jlc = _load()
    port = AudioPipeline(lc.cfg, [UniformSpec(*u) for u in uniforms], device="cpu")
    ref = JaxPipeline(jlc.cfg, [JaxUniform(*u) for u in uniforms], use_fused=False)
    rng = np.random.default_rng(12)
    sp, sj = port.init_state(), ref.init_state()
    assert sp.count.shape == (len(uniforms) - 1,)
    for _ in range(3):
        al = (rng.standard_normal(1024) * 0.7).astype(np.float32)
        ar = (rng.standard_normal(1024) * 0.7).astype(np.float32)
        sp, tp = port.update(sp, torch.as_tensor(al), torch.as_tensor(ar))
        sj, tj = ref.update(sj, jnp.asarray(al), jnp.asarray(ar))
        assert tp.keys() == tj.keys()
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(tj[k]),
                                       atol=5e-5)
    assert torch.equal(tp["wave_l"], torch.clamp(
        (torch.as_tensor(al) + 1.0) / 2.0, 0.0, 1.0))


@pytest.mark.parametrize("case", ["cpu_path", "chain", "smooth", "bufsize131072",
                                  "bufsize33554432"])
def test_configuration_routes(case):
    """The update route of configurations the port once refused: the
    CPU path takes the chain route at any bufsize (131072 too), an fft
    chain holding ``smooth`` takes the fft update, a stateless
    ``smooth`` chain keeps no state (their values are held against the
    JAX package in tests/test_torch_cpu_path.py), and the accel path
    above the one-cluster kernel's 65536 takes the kernel route, the
    split plan on the card (its values in ``CHAIN_CASES`` below), up
    to 2^24; above that, where no split plan fits, the chain, as the
    JAX package takes its XLA chain."""
    cfg = RenderConfig(bufsize=1024)
    uniforms = [UniformSpec(*u) for u in BARS]
    if case == "cpu_path":
        for n in (1024, 131072):
            # (smooth pass off: its dense matrix at 131072 would not fit)
            p = AudioPipeline(dataclasses.replace(cfg, accel_fft=False,
                                                  bufsize=n,
                                                  smooth_pass=n < 65536),
                              uniforms, device="cpu")
            assert p.route == "chain"
    elif case == "chain":
        uniforms = [UniformSpec("audio_l", "audio_l", ("window", "fft", "smooth"))]
        p = AudioPipeline(cfg, uniforms, device="cpu")
        assert p.route == "kernel" and p.fft_uniforms == uniforms
    elif case == "smooth":
        uniforms = [UniformSpec("audio_l", "audio_l", ("wrange", "smooth"))]
        p = AudioPipeline(cfg, uniforms, device="cpu")
        assert p.route is None and p.init_state().count.numel() == 0
    elif case == "bufsize131072":
        from glava_tpu_torch.ops import fused

        p = AudioPipeline(dataclasses.replace(cfg, bufsize=131072,
                                              smooth_pass=False),
                          uniforms, device="cpu")
        assert p.route == "kernel" and fused.fft_plan(p.sz).split
    else:
        from glava_tpu_torch.ops import fused

        p = AudioPipeline(dataclasses.replace(cfg, bufsize=1 << 25,
                                              smooth_pass=False),
                          uniforms, device="cpu")
        assert p.sz > fused.MAX_SPLIT_N and p.route == "chain"


# ---------------------------------------------------------------------------
# bufsizes off the shipped 4096: the plain chain below 256, the kernel's
# largest sizes above 16384 (its split plans above 65536)
# ---------------------------------------------------------------------------

# (requests, smooth pass, updates, route): scaled bufsizes outside
# 256..16384. At 4 and 16 the smooth pass maps every texel to 0 (its
# log-curve spans hold no texel), so those cases compare the averaged
# spectrum itself; from 32768 up its dense resample matrix would
# take 4 GB a package and more, so they compare the average too (the
# smooth pass is held at 64, 128 and 4096 / bufscale 32 here, and at
# 32768 through Renderer by chip_smoke.py on the card).
CHAIN_CASES = {
    "bufsize4": (("setbufsize 4", "setsamplesize 4"), False, 8, "chain"),
    "bufsize16": (("setbufsize 16", "setsamplesize 16"), False, 8, "chain"),
    "bufsize64": (("setbufsize 64", "setsamplesize 64"), True, 8, "chain"),
    "bufsize128": (("setbufsize 128", "setsamplesize 128"), True, 8, "chain"),
    "bufsize4096_bufscale32": (("setbufsize 4096", "setbufscale 32"), True, 8,
                               "chain"),
    "bufsize32768": (("setbufsize 32768",), False, 4, "kernel"),
    "bufsize65536": (("setbufsize 65536",), False, 3, "kernel"),
    "bufsize131072": (("setbufsize 131072",), False, 3, "kernel"),
    "bufsize262144": (("setbufsize 262144",), False, 2, "kernel"),
}


def _presmooth64(op, tex):
    """The baked smooth-pass operator applied in float64, dense or
    block-banded (the same float32 weights as both packages')."""
    if op.banded is None:
        return tex[..., : op.matrix.shape[1]] @ op.matrix.T.astype(np.float64)
    b = op.banded
    kb = b.blocks.shape[2]
    pad = np.pad(tex, [(0, 0)] * (tex.ndim - 1) + [(0, kb)])
    out = np.concatenate([pad[..., s:s + kb] @ blk.T.astype(np.float64)
                          for s, blk in zip(b.starts, b.blocks)], axis=-1)
    return out[..., : b.n_out]


def _chain_model64(cfg, audio, presmooth):
    """The accel chain in float64 numpy: decimate, window, packed FFT,
    log-magnitude and boost, clamp, gravity, ring write, age-weighted
    average, clamp, then the smooth pass (``presmooth``, or None) and a
    clamp. ``audio`` (updates, 2, bufsize) -> (updates, 2, sz)."""
    from glava_tpu_torch.ops import fused, windows

    n, F = cfg.scaled_bufsize, cfg.avg_frames
    window = windows.pcm_window(n).astype(np.float64)
    w_age = fused.age_weights(windows.avg_weights(F, cfg.avg_window, True))
    boost = np.maximum(np.arange(n) / n * np.float32(cfg.fft_scale)
                       + (1.0 - np.float32(cfg.fft_cutoff)), 1.0)
    g = np.float32(cfg.gravity_step / cfg.nominal_ups)
    grav, hist, out = np.zeros((2, n)), np.zeros((2, F, n)), []
    for k, x in enumerate(audio):
        if cfg.bufscale > 1:
            x = x.reshape(2, n, cfg.bufscale).mean(axis=-1, dtype=np.float32)
        x = x.astype(np.float64) * window
        spec = np.fft.fft(x[:, 0::2] + 1j * x[:, 1::2])
        inter = np.stack([spec.real, spec.imag], axis=-1).reshape(2, n)
        spec = np.clip(np.log(np.abs(inter) + 1.0) / 3.0 * boost, 0.0, 1.0)
        grav = np.clip(np.maximum(grav, spec) - g, 0.0, 1.0)
        slot = k % F
        hist[:, slot] = grav
        tex = np.clip(np.einsum("f,cfn->cn", w_age[(slot - np.arange(F)) % F]
                                .astype(np.float64), hist), 0.0, 1.0)
        if presmooth is not None:
            tex = np.clip(_presmooth64(presmooth, tex), 0.0, 1.0)
        out.append(tex)
    return out


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_route_textures_match_jax(case):
    """Every power-of-two bufsize below the kernel's runs the plain
    chain (``route == "chain"``), the one-cluster kernel's two largest
    and the split route's two smallest the kernel route (on the CPU, the
    kernel's plain version); each gives the JAX pipeline's
    textures within 2e-5 after every update. Where the JAX float32 chain
    itself lies farther than 2e-5 from a float64 numpy model of the
    chain, the tolerance is that measured distance instead (it grows
    with the bufsize, from about 1e-7 at 128 and below to under 1e-5 at
    32768 and 65536 and about 1.9e-5 at 131072, so 2e-5 holds)."""
    from glava_tpu_torch.ops import fused

    reqs, smooth, updates, route = CHAIN_CASES[case]
    lc, jlc = (ld.load(cli_requests=reqs + ("setprintframes false",),
                       force_module="bars") for ld in (loader, jloader))
    cfg = dataclasses.replace(lc.cfg, smooth_pass=smooth)
    jcfg = dataclasses.replace(jlc.cfg, smooth_pass=smooth)
    port = AudioPipeline(cfg, [UniformSpec(*u) for u in BARS], device="cpu")
    ref = JaxPipeline(jcfg, [JaxUniform(*u) for u in BARS], use_fused=False)
    assert port.route == route
    assert fused.update_route(cfg.scaled_bufsize) == route
    rng = np.random.default_rng(cfg.scaled_bufsize)
    audio = (rng.standard_normal((updates, 2, cfg.bufsize)) * 0.3
             ).astype(np.float32)
    model = _chain_model64(cfg, audio, smoothing.presmooth_op(
        cfg.scaled_bufsize, smoothing.SmoothParams(factor=cfg.smooth_factor))
        if smooth else None)
    sp, sj = port.init_state(), ref.init_state()
    got, want = [], []
    for al, ar in audio:
        sp, tp = port.update(sp, torch.as_tensor(al), torch.as_tensor(ar))
        sj, tj = ref.update(sj, jnp.asarray(al), jnp.asarray(ar))
        got.append(np.stack([tp["audio_l"].numpy(), tp["audio_r"].numpy()]))
        want.append(np.stack([np.asarray(tj["audio_l"]),
                              np.asarray(tj["audio_r"])]))
    got, want, model = map(np.asarray, (got, want, model))
    assert got.shape == (updates, 2, cfg.scaled_bufsize)
    assert (got[-1] > 0).any()
    jax_to_model = float(np.abs(want - model).max())
    tol = max(2e-5, jax_to_model)
    np.testing.assert_allclose(got, want, atol=tol)


def test_update_route_follows_the_shape():
    """The chain below the kernel's bufsizes, the kernel from 256 up
    (the one-cluster plans to 65536, the split plans above), as the JAX
    package's ``_fused_supported`` sets no upper limit; lengths that are
    not a power of two raise ``ValueError``."""
    from glava_tpu_torch.ops import fused

    assert [fused.update_route(1 << k) for k in range(2, 23)] == (
        ["chain"] * 6 + ["kernel"] * 15)
    assert [fused.fft_plan(1 << k).split for k in range(8, 23)] == (
        [False] * 9 + [True] * 6)
    for n in (0, 1, 2, 3, 96, 1000, 4097):
        with pytest.raises(ValueError, match="power of two"):
            fused.update_route(n)


def test_update_route_takes_the_chain_above_the_split_plans():
    """The kernel up to MAX_SPLIT_N (2^24), the largest split plan; the
    chain at 2x and 4x that, chosen from n before any launch, while a
    direct ``fft_plan`` call there still raises."""
    from glava_tpu_torch.ops import fused

    top = fused.MAX_SPLIT_N
    assert fused.fft_plan(top).split
    assert [fused.update_route(n) for n in (top, 2 * top, 4 * top)] == [
        "kernel", "chain", "chain"]
    with pytest.raises(ValueError, match="power of two in"):
        fused.fft_plan(2 * top)


@pytest.mark.parametrize("bufsize", [3, 96])
def test_bufsize_not_a_power_of_two_raises(bufsize):
    """As the JAX package's ``plan_packed_fft`` refuses them."""
    cfg = RenderConfig(bufsize=bufsize)
    with pytest.raises(ValueError, match="power of two"):
        AudioPipeline(cfg, [UniformSpec(*u) for u in BARS], device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        jfft.plan_packed_fft(bufsize)

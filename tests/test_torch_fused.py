"""The port's fused spectrum update against the JAX package.

Inputs are made with numpy from a seed and fed to both packages. The
JAX Pallas kernels run in interpret mode on the CPU, as
tests/test_fused.py runs them. Tolerance: 2e-5 on spectra, gravity,
history and average (the JAX suite's fused-vs-unfused tolerance).
Cases marked ``cuda`` compare the CUDA kernel with the plain version
and skip where there is no card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from glava_tpu.ops import transforms as jtransforms
from glava_tpu.ops import windows as jwindows
from glava_tpu.ops.pallas import fused as jfused
from glava_tpu_torch.ops import fused, windows

TOL = 2e-5


def _weights(F):
    return tuple(float(x) for x in jwindows.avg_weights(F, True, True))


def _plain_args(n, F, dev="cpu"):
    window = torch.as_tensor(windows.pcm_window(n), device=dev)
    w_age = torch.as_tensor(
        fused.age_weights(windows.avg_weights(F, True, True)), device=dev)
    return window, w_age


def _jax_step(builder, fn, pcm, grav, hist, ssum, slot, scale, cut, g):
    """One update through a JAX fused builder -> (grav, hist, avg)."""
    if builder == "v1":   # scalar slot, returns (avg, grav, hist)
        avg, grav, hist = fn(pcm, grav, hist, int(slot[0]), scale, cut, g)
        return grav, hist, avg
    return fn(pcm, grav, hist, ssum, slot, scale, cut, g)


@pytest.mark.parametrize("builder", ["inc", "ring", "v1"])
def test_plain_matches_pallas_kernels(builder):
    """7 updates of fresh audio with per-row parameters and staggered
    per-row slots (one shared slot for the scalar-slot v1 kernel)."""
    n, F, B = 512, 5, 4
    build = {"inc": jfused.build_fused_update_inc,
             "ring": jfused.build_fused_update_ring,
             "v1": jfused.build_fused_update}[builder]
    fn = build(n, F, _weights(F), batch_tile=4, interpret=True)
    rng = np.random.default_rng(0)
    m = n // 2
    grav = np.zeros((B, 2, m), np.float32)
    hist = np.zeros((B, F, 2, m), np.float32)
    jg, jh, js = jnp.asarray(grav), jnp.asarray(hist), jnp.asarray(grav)
    tg, th = torch.as_tensor(grav), torch.as_tensor(hist)
    window, w_age = _plain_args(n, F)
    count = np.zeros(B, np.int32) if builder == "v1" else np.arange(B) % F
    scale = rng.uniform(5.0, 20.0, B).astype(np.float32)
    cut = rng.uniform(0.0, 0.5, B).astype(np.float32)
    g = rng.uniform(0.01, 0.2, B).astype(np.float32)
    for _ in range(7):
        pcm = (rng.standard_normal((B, n)) * 0.3).astype(np.float32)
        slot = count.astype(np.int32)
        jg, jh, js = _jax_step(builder, fn, jnp.asarray(pcm), jg, jh, js,
                               jnp.asarray(slot), jnp.asarray(scale),
                               jnp.asarray(cut), jnp.asarray(g))
        tg, th, tavg = fused.fused_update_plain(
            torch.as_tensor(pcm), tg, th, torch.as_tensor(slot),
            torch.as_tensor(scale), torch.as_tensor(cut), torch.as_tensor(g),
            window, w_age)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL)
        np.testing.assert_allclose(tavg.numpy(), np.asarray(js), atol=TOL)
        count = (count + 1) % F


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_plain_matches_fft_update(n):
    """Against the JAX unfused chain ``transforms.fft_update``, whose
    history is positional (oldest first), over one shared slot."""
    F, B = 6, 3
    rng = np.random.default_rng(1)
    state = jtransforms.chain_init(n, F, batch=(B,))
    w = jnp.asarray(jwindows.avg_weights(F, True, True))
    tg = torch.zeros((B, 2, n // 2))
    th = torch.zeros((B, F, 2, n // 2))
    window, w_age = _plain_args(n, F)
    ones = torch.ones(B)
    for it in range(7):
        pcm = (rng.standard_normal((B, n)) * 0.3).astype(np.float32)
        state, want = jtransforms.fft_update(
            state, jnp.asarray(pcm), fft_scale=10.2, fft_cutoff=0.3,
            gravity_g=0.05, avg_weights=w)
        tg, th, tavg = fused.fused_update_plain(
            torch.as_tensor(pcm), tg, th,
            torch.full((B,), it % F, dtype=torch.int32),
            ones * 10.2, ones * 0.3, ones * 0.05, window, w_age)
    got = torch.stack([tavg[:, 0], tavg[:, 1]], dim=-1).reshape(B, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_wrapper_on_cpu_is_the_plain_version_in_place():
    n, F, B = 512, 6, 3
    rng = np.random.default_rng(2)
    window, w_age = _plain_args(n, F)
    pcm = torch.as_tensor((rng.standard_normal((B, n)) * 0.3).astype(np.float32))
    grav = torch.as_tensor(rng.uniform(0, 1, (B, 2, n // 2)).astype(np.float32))
    hist = torch.as_tensor(rng.uniform(0, 1, (B, F, 2, n // 2)).astype(np.float32))
    args = (torch.tensor([0, 3, 5], dtype=torch.int32), torch.full((B,), 10.2),
            torch.full((B,), 0.3), torch.full((B,), 0.05), window, w_age)
    want = fused.fused_update_plain(pcm, grav, hist, *args)
    before = fused.launches
    g2, h2, avg = fused.fused_update(pcm, grav, hist, *args)
    assert g2 is grav and h2 is hist       # updated in place
    assert fused.launches == before        # no kernel on the CPU
    for got, exp in zip((g2, h2, avg), want):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("bad", ["n", "dtype", "shape", "contiguous", "slot"])
def test_launch_validates_inputs(bad):
    """The CUDA launcher checks its inputs before it builds or launches
    anything (these checks run on any device)."""
    n, F, B = 512, 6, 2
    window, w_age = _plain_args(n, F)
    pcm = torch.zeros(B, n)
    grav = torch.zeros(B, 2, n // 2)
    hist = torch.zeros(B, F, 2, n // 2)
    slot = torch.zeros(B, dtype=torch.int32)
    if bad == "n":
        pcm, window = torch.zeros(B, 384), torch.zeros(384)
    elif bad == "dtype":
        grav = grav.double()
    elif bad == "shape":
        hist = torch.zeros(B, F, 2, n // 4)
    elif bad == "contiguous":
        grav = torch.zeros(B, n // 2, 2).transpose(1, 2)
    else:
        slot = slot.long()
    with pytest.raises((ValueError, TypeError)):
        fused._launch(pcm, grav, hist, slot, torch.ones(B), torch.ones(B),
                      torch.ones(B), window, w_age)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1024, 4096, 16384])
@pytest.mark.parametrize("B", [2, 64])
def test_kernel_matches_plain_on_card(cuda, n, B):
    F = 6
    rng = np.random.default_rng(3)
    window, w_age = _plain_args(n, F, cuda)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    grav = t(rng.uniform(0, 1, (B, 2, n // 2)))
    hist = t(rng.uniform(0, 1, (B, F, 2, n // 2)))
    count = np.arange(B) % F
    for _ in range(8):
        pcm = t(rng.standard_normal((B, n)) * 0.3)
        slot = torch.as_tensor(count, dtype=torch.int32, device=cuda)
        params = (t(rng.uniform(5, 20, B)), t(rng.uniform(0, 0.5, B)),
                  t(rng.uniform(0.01, 0.1, B)))
        pg, ph, pavg = fused.fused_update_plain(
            pcm, grav, hist, slot, *params, window, w_age)
        kg, kh, kavg = fused.fused_update(
            pcm, grav.clone(), hist.clone(), slot, *params, window, w_age)
        torch.cuda.synchronize()
        written = torch.zeros(B, F, dtype=torch.bool, device=cuda)
        written[torch.arange(B, device=cuda), slot.long()] = True
        assert (kg - pg).abs().max().item() <= TOL
        assert (kavg - pavg).abs().max().item() <= TOL
        assert (kh[written] - ph[written]).abs().max().item() <= TOL
        assert torch.equal(kh[~written], hist[~written])
        grav, hist = kg, kh
        count = (count + 1) % F


@pytest.mark.cuda
def test_kernel_counts_launches(cuda):
    n, F, B = 1024, 6, 2
    window, w_age = _plain_args(n, F, cuda)
    z = lambda *s: torch.zeros(s, device=cuda)  # noqa: E731
    before = fused.launches
    fused.fused_update(z(B, n), z(B, 2, n // 2), z(B, F, 2, n // 2),
                       torch.zeros(B, dtype=torch.int32, device=cuda),
                       z(B) + 10.2, z(B) + 0.3, z(B) + 0.05, window, w_age)
    torch.cuda.synchronize()
    assert fused.launches == before + 1

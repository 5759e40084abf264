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


@pytest.mark.parametrize("bad", ["n", "dtype", "shape", "contiguous", "slot",
                                 "aligned"])
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
    elif bad == "slot":
        slot = slot.long()
    else:   # the history's tensor copies take 16-byte-aligned rows
        hist = torch.zeros(B * F * n + 1)[1:].view(B, F, 2, n // 2)
    with pytest.raises((ValueError, TypeError)):
        fused._launch(pcm, grav, hist, slot, torch.ones(B), torch.ones(B),
                      torch.ones(B), window, w_age)


def _split_fft_model(x, plan):
    """csrc/fused_update.cu's FFT of one row in numpy float64, read
    from ``plan`` with the kernel's index mapping: CTA j1 loads
    ``x[j1 + k*j2]``, runs the Stockham passes (pass s of radix R reads
    ``a[j + r*m2/R]``, scales by ``W^(jm*r*m2/(Ns*R))`` from the table,
    with jm = j mod Ns, and writes ``(j - jm)*R + jm + r*Ns``), scales
    bin f2 by ``W_m^(j1*f2)`` on the last pass and stores it into the
    receive buffer of CTA f2 // run at ``j1*run + f2 % run``; CTA
    ``rank`` takes the k-point DFT over j1 of each receive column u into
    bins ``f1*m2 + rank*run + u``."""
    k, m2 = plan.k, plan.m2
    run = m2 // k
    tw = fused.twiddle_table(plan)
    inner, outer = tw[:m2], tw[m2:].reshape(k, m2)
    recv = np.empty((k, m2), np.complex128)     # [owner, j1*run + u]
    for j1 in range(k):
        a = x[j1 + k * np.arange(m2)]
        Ns = 1
        for s, R in enumerate(plan.radices):
            Q = m2 // R
            j = np.arange(Q)
            jm = j % Ns
            r = np.arange(R)[:, None]
            v = a[j + r * Q] * inner[jm * r * (m2 // (Ns * R))]
            v = np.fft.fft(v, axis=0)          # the R-point butterfly
            at = (j - jm) * R + jm + r * Ns
            if s < len(plan.radices) - 1:
                a = np.empty_like(a)
                a[at] = v
            else:
                recv[at // run, j1 * run + at % run] = v * outer[j1][at]
            Ns *= R
    X = np.empty(plan.m, np.complex128)
    f1 = np.arange(k)[:, None]
    for rank in range(k):
        cols = np.fft.fft(recv[rank].reshape(k, run), axis=0)   # over j1
        X[(f1 * m2 + rank * run + np.arange(run)).reshape(-1)] = cols.reshape(-1)
    return X


NS = [256 << i for i in range(9)]   # every bufsize of the one-cluster plans


@pytest.mark.parametrize("n", NS)
def test_split_fft_model_matches_numpy(n):
    """The kernel's cluster split, read from fused.fft_plan(n), is the
    m-point DFT to 1e-12 of the spectrum's largest magnitude; from
    n 4096 up it runs on a cluster of k > 1 CTAs."""
    plan = fused.fft_plan(n)
    assert plan.k * plan.m2 == plan.m and 1 <= plan.k <= fused.MAX_CLUSTER
    assert int(np.prod(plan.radices)) == plan.m2
    assert all(r in (4, 8) for r in plan.radices)   # the kernel's passes
    assert plan.k > 1 if n >= 4096 else True
    assert plan.m2 // plan.k >= 32      # runs of 128 bytes or more
    rng = np.random.default_rng(n)
    x = rng.standard_normal(plan.m) + 1j * rng.standard_normal(plan.m)
    want = np.fft.fft(x)
    got = _split_fft_model(x, plan)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("F", [1, 6, 16, 64])
@pytest.mark.parametrize("n", NS)
def test_plan_shared_memory_fits(n, F):
    """A CTA's shared memory stays under the H100's 227 KB: the whole
    history ring resident for F in {1, 6, 16} wherever a CTA's FFT is
    at most 1024 points (n up to 16384); where it cannot be (F 64 at n
    16384, F above 3 at n 32768 and 65536, whose CTAs run 2048-point
    FFTs) the plan names the streamed route, with groups of slots that
    fit."""
    plan = fused.fft_plan(n)
    G = plan.slots(F)
    assert 1 <= G <= F
    assert plan.smem_bytes(F) <= fused.SMEM_LIMIT
    # one slot more would not fit: G is the most the streamed route can hold
    assert G == F or plan.smem_bytes(F) + 8 * plan.m2 > fused.SMEM_LIMIT
    if F <= 16 and plan.m2 <= 1024:
        assert G == F
    if (n == 16384 and F == 64) or (n >= 32768 and F > 3):
        assert G < F          # streamed


def test_plan_radix_code_and_twiddles():
    """What the wrapper hands the kernel: log2 radices in 2-bit fields
    and the table's two parts."""
    plan = fused.fft_plan(16384)
    assert plan.radices == (8, 8, 4, 4) and plan.radix_code == 0b10_10_11_11
    tw = fused.twiddle_table(plan)
    assert tw.shape == (plan.m2 + plan.m,)
    np.testing.assert_allclose(tw[1], np.exp(-2j * np.pi / plan.m2), rtol=0, atol=1e-15)
    np.testing.assert_allclose(tw[plan.m2 + 3 * plan.m2 + 5],
                               np.exp(-2j * np.pi * 15 / plan.m), rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="power of two"):
        fused.fft_plan(384)


@pytest.mark.parametrize("F", [1, 6, 64])
@pytest.mark.parametrize("n", NS)
def test_plan_args_as_the_kernel_takes_them(n, F):
    """The C entry's plan arguments: k, the pass count, 2-bit log2
    radices of 2 or 3 (radix 4 or 8, the only passes it has), and the
    plan's slots and shared memory; 2*m2 elements fill 1 to 16 per
    thread of its 256; a cluster of 16 CTAs only where 8 would need
    FFTs of more than 2048 points."""
    plan = fused.fft_plan(n)
    k, nstages, code, G, smem = fused._plan_args(n, F)
    assert (k, G, smem) == (plan.k, plan.slots(F), plan.smem_bytes(F))
    fields = [(code >> (2 * s)) & 3 for s in range(nstages)]
    assert fields and all(f in (2, 3) for f in fields)
    assert code >> (2 * nstages) == 0
    assert 2 ** sum(fields) == plan.m2
    assert 256 <= 2 * plan.m2 <= 16 * 256
    assert plan.k <= fused.PORTABLE_CLUSTER or n == fused.MAX_N == 65536


def _stockham(a, radices, table):
    """The kernels' Stockham passes along axis 0 of ``a`` (points,
    columns), twiddles ``table[t] = W_points^t``: pass s of radix R
    reads ``a[j + r*Q]``, scales by ``W^(jm*r*points/(Ns*R))`` and
    writes ``(j - jm)*R + jm + r*Ns``, jm = j mod Ns."""
    points = a.shape[0]
    Ns = 1
    for R in radices:
        Q = points // R
        j = np.arange(Q)
        jm = j % Ns
        r = np.arange(R)[:, None]
        v = a[j + r * Q] * table[jm * r * (points // (Ns * R))][..., None]
        v = np.fft.fft(v, axis=0)              # the R-point butterfly
        a = np.empty_like(a)
        a[((j - jm) * R + jm + r * Ns).reshape(-1)] = v.reshape(R * Q, -1)
        Ns *= R
    return a


def _split_route_model(x, plan, cols):
    """csrc/fused_update.cu's split route on one row in numpy float64,
    read from ``plan``: column CTA blk stages ``x[j1 + k*j2]`` for its
    ``cols`` columns j1 = blk*cols + c, runs the m2-point Stockham FFT
    of each and writes ``Y[j1, f2] = FFT * W_m^(j1*f2)``; stage CTA blk
    reads ``Y[:, blk*run + col]``, runs the k-point Stockham passes on
    all its columns, and element i of its epilogue (plane c, local l)
    is bin ``(l // run)*m2 + blk*run + l % run``."""
    k, m2, run = plan.k, plan.m2, plan.split_run
    tw = fused.twiddle_table(plan)
    inner, outer = tw[:m2], tw[m2:m2 + plan.m].reshape(k, m2)
    ktw = tw[m2 + plan.m:]
    Y = np.empty((k, m2), np.complex128)
    for blk in range(-(-k // cols)):
        j1 = blk * cols + np.arange(min(cols, k - blk * cols))
        stage = x[j1[None, :] + k * np.arange(m2)[:, None]]     # (m2, cols)
        Y[j1] = (_stockham(stage, plan.radices, inner) * outer[j1].T).T
    X = np.empty(plan.m, np.complex128)
    for blk in range(m2 // run):
        z = _stockham(Y[:, blk * run:(blk + 1) * run], plan.stage_radices,
                      ktw).reshape(-1)                          # [f1*run + col]
        X[_stage_bins(plan, blk)] = z
    return X


def _stage_bins(plan, blk):
    """The bin of each local element l < k*run of stage CTA ``blk``:
    ``(l // run)*m2 + blk*run + l % run``."""
    run = plan.split_run
    l = np.arange(plan.split_points)
    return (l // run) * plan.m2 + blk * run + l % run


SPLIT_NS = [1 << p for p in range(17, 23)]


@pytest.mark.parametrize("n", SPLIT_NS)
def test_split_route_model_matches_numpy(n):
    """Above 65536 the plan is the split route: k = m/2048 column FFTs
    of 2048 points (the one-cluster kernel's passes), the k-point stage
    in radix-8/4 passes, no cluster; its index mapping, read from
    fused.fft_plan(n), is the m-point DFT to 1e-12 of the spectrum's
    largest magnitude, with one column a column CTA and with
    SPLIT_COLS."""
    plan = fused.fft_plan(n)
    assert plan.split and plan.m2 == fused.MAX_CTA_POINTS
    assert plan.k * plan.m2 == plan.m and plan.k >= 32
    assert int(np.prod(plan.stage_radices)) == plan.k
    assert all(r in (4, 8) for r in plan.radices + plan.stage_radices)
    rng = np.random.default_rng(n)
    x = rng.standard_normal(plan.m) + 1j * rng.standard_normal(plan.m)
    want = np.fft.fft(x)
    for cols in (1, fused.SPLIT_COLS):
        got = _split_route_model(x, plan, cols)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("F", [1, 6, 64])
@pytest.mark.parametrize("n", SPLIT_NS + [1 << 23, 1 << 24])
def test_split_args_as_the_kernel_takes_them(n, F):
    """The split C entry's plan arguments: the 2048-point column FFT's
    and the k-point stage's 2-bit log2 radices, columns a column CTA
    takes (SPLIT_COLS only where the rows still give SPLIT_CTAS CTAs),
    a power-of-two run of f2 dividing m2 with runs of 16 bytes or more
    up to k 1024, the resident history slots, the copy mode, and both
    CTAs' shared memory under the
    H100's 227 KB for any ring (a stage CTA streams a ring that does not
    fit); the plan stops at MAX_SPLIT_N."""
    plan = fused.fft_plan(n)
    for B in (1, 2, 128):
        (k, nstages, code, kstages, kcode, cols, run, G, tensor, smem_a,
         smem_b) = fused._split_args(n, F, B)
        assert (k, code) == (plan.k, plan.radix_code)
        assert 2 ** sum((code >> (2 * s)) & 3 for s in range(nstages)) == plan.m2
        fields = [(kcode >> (2 * s)) & 3 for s in range(kstages)]
        assert all(f in (2, 3) for f in fields) and 2 ** sum(fields) == k
        assert cols == (fused.SPLIT_COLS
                        if B * k >= fused.SPLIT_CTAS * fused.SPLIT_COLS else 1)
        assert run & (run - 1) == 0 and plan.m2 % run == 0
        assert run >= 4 if k <= 1024 else run >= 1
        assert G == plan.split_slots(F) and 1 <= G <= F
        assert tensor == (run >= 4)
        assert (smem_a, smem_b) == plan.split_smem(F, cols)
        assert max(smem_a, smem_b) <= fused.SMEM_LIMIT
    with pytest.raises(ValueError, match="power of two"):
        fused.fft_plan(fused.MAX_SPLIT_N * 2)


SPLIT_ALL = SPLIT_NS + [1 << 23, 1 << 24]


@pytest.mark.parametrize("F", [1, 6, 16, 64])
@pytest.mark.parametrize("n", SPLIT_ALL)
def test_split_plan_slots_copies_and_shared_memory(n, F):
    """A stage CTA's plan at every split n: points 1024 to k 256, 2048
    at k 512 and 4096 above; tensor copies where a run is 16 bytes or
    more (k <= 1024, 1 to 4 boxes a plane), cp.async below; the k-point
    twiddles in shared memory up to 2048 points. The whole ring resident
    to F 23 at 1024 points (F 22 at k 256), F 8 at 2048 and 2 slots at
    4096, each the most that fits: one slot more would pass 227 KB. The
    column CTA's 112 KB at one column leave room for two CTAs an SM
    (228 KB)."""
    plan = fused.fft_plan(n)
    P = plan.split_points
    k = plan.k
    assert P == {True: 1024, False: 2048 if k == 512 else 4096}[k <= 256]
    assert P == k * plan.split_run
    assert plan.split_copy == ("tensor" if k <= 1024 else "cp.async")
    assert plan.split_tw_shared == (k <= 512)
    G = plan.split_slots(F)
    resident = {1024: 23 if k <= 128 else 22, 2048: 8, 4096: 2}[P]
    assert G == min(F, resident)
    for cols in (1, fused.SPLIT_COLS):
        smem_a, smem_b = plan.split_smem(F, cols)
        assert max(smem_a, smem_b) <= fused.SMEM_LIMIT
        assert smem_b + 8 * P > fused.SMEM_LIMIT or G == F
    assert 2 * (plan.split_smem(F, 1)[0] + 1024) <= 228 * 1024


def _prefetch_model(plan, F, B, row, blk, sl, grp):
    """csrc/fused_update.cu ``issue_split_history`` in numpy: after group
    ``grp``'s copies, the flat index into gravity (B, 2, m) of each float
    of a stage CTA's gravity share ``gs`` (group 0 only) and into the
    history (B, F, 2, m) of each float of its G slot shares ``hs``, -1
    where nothing lands. Tensor copies move boxes (run, min(k, 256), 1)
    of the (m2, k, planes) view at (blk*run, y0, plane), packed innermost
    first, to ``c*P + y0*run``; cp.async moves element i of a share from
    plane c = i // P, bin f1*m2 + blk*run + u of l = i % P = f1*run + u.
    Also returns the byte offsets of every tensor copy's destination."""
    k, m2, run, P, m = plan.k, plan.m2, plan.split_run, plan.split_points, plan.m
    G = plan.split_slots(F)
    gs = np.full(2 * P, -1, np.int64)
    hs = np.full((G, 2 * P), -1, np.int64)
    f0, f1 = grp * G, min(F, grp * G + G)
    dsts = []
    gs_at = 128 + 32 * P + (16 * k if plan.split_tw_shared else 0)

    def put(dst, at, index, count):
        assert (dst[at:at + count] == -1).all()     # nothing lands twice
        dst[at:at + count] = index

    if plan.split_copy == "tensor":
        kbox = min(k, fused.SPLIT_BOX)
        yy, xx = np.meshgrid(np.arange(kbox), np.arange(run), indexing="ij")
        for c in range(2):
            for y0 in range(0, k, kbox):
                at = c * P + y0 * run
                box = ((y0 + yy) * m2 + blk * run + xx).reshape(-1)
                if grp == 0:
                    put(gs, at, (2 * row + c) * m + box, kbox * run)
                    dsts.append(gs_at + 4 * at)
                for f in range(f0, f1):
                    if f != sl:
                        put(hs[f - f0], at, (2 * (row * F + f) + c) * m + box,
                            kbox * run)
                        dsts.append(gs_at + 8 * P * (1 + f - f0) + 4 * at)
    else:
        i = np.arange(2 * P)
        c, l = i // P, i % P
        at = c * m + (l // run) * m2 + blk * run + l % run
        if grp == 0:
            put(gs, 0, row * 2 * m + at, 2 * P)
        for f in range(f0, f1):
            if f != sl:
                put(hs[f - f0], 0, (row * F + f) * 2 * m + at, 2 * P)
    return gs, hs, dsts


@pytest.mark.parametrize("F", [1, 6, 16, 32])
@pytest.mark.parametrize("n", SPLIT_ALL)
def test_split_prefetch_lands_where_the_epilogue_reads(n, F):
    """Every float the epilogue reads from shared memory is the one its
    bin needs: element i of a share (plane c = i // P, l = i % P) holds
    plane c of bin ``_stage_bins(plan, blk)[l]`` (the bin mapping of
    ``_split_route_model``), for the gravity and for every slot of every
    group but the row's own, which nothing copies; every tensor copy
    lands on a 128-byte boundary of shared memory."""
    plan = fused.fft_plan(n)
    P, m, G = plan.split_points, plan.m, plan.split_slots(F)
    B, row = 2, 1
    for blk in (0, plan.m2 // plan.split_run - 1):
        bins = _stage_bins(plan, blk)
        want = np.concatenate([bins, m + bins])          # [c*P + l]
        for sl in sorted({0, F - 1}):
            for grp in range(-(-F // G)):
                gs, hs, dsts = _prefetch_model(plan, F, B, row, blk, sl, grp)
                assert all(d % 128 == 0 for d in dsts)
                if grp == 0:
                    assert (gs == row * 2 * m + want).all()
                for f in range(grp * G, min(F, grp * G + G)):
                    got = hs[f - grp * G]
                    if f == sl:
                        assert (got == -1).all()
                    else:
                        assert (got == (row * F + f) * 2 * m + want).all()


@pytest.mark.parametrize("F", [6, 32])
def test_split_epilogue_model_sums_the_ring_in_f_order(F):
    """The epilogue's average over the groups of resident slots, read
    from the prefetch model's shared memory and summed in f order group
    after group (the running sums parked between groups, float32 adds
    of float32 products), equals the plain version's ``ring_average``
    on the bins of every stage CTA; F 32 at n 131072 streams the ring
    through 23 slots."""
    n, B = 1 << 17, 2
    plan = fused.fft_plan(n)
    P, m, G = plan.split_points, plan.m, plan.split_slots(F)
    assert (G < F) == (F == 32)
    rng = np.random.default_rng(F)
    hist = rng.uniform(0, 1, (B, F, 2, m)).astype(np.float32)
    newest = np.array([3 % F, F - 1], np.int32)
    w_age = fused.age_weights(windows.avg_weights(F, True, True))
    want = fused.ring_average(torch.as_tensor(hist), torch.as_tensor(newest),
                              torch.as_tensor(w_age)).numpy().reshape(B, -1)
    flat = hist.reshape(-1)
    for row in range(B):
        sl = int(newest[row])
        for blk in (0, 5, plan.m2 // plan.split_run - 1):
            bins = np.concatenate([_stage_bins(plan, blk),
                                   m + _stage_bins(plan, blk)])
            gval = flat[(row * F + sl) * 2 * m + bins]
            acc = np.zeros(2 * P, np.float32)
            for grp in range(-(-F // G)):
                _, hs, _ = _prefetch_model(plan, F, B, row, blk, sl, grp)
                for f in range(grp * G, min(F, grp * G + G)):
                    v = gval if f == sl else flat[hs[f - grp * G]]
                    acc = acc + np.float32(w_age[(sl - f) % F]) * v
            got = np.clip(acc, 0.0, 1.0)
            np.testing.assert_array_equal(got, want[row, bins])


def test_split_twiddles_append_the_stage_table():
    plan = fused.fft_plan(1 << 18)
    tw = fused.twiddle_table(plan)
    assert tw.shape == (plan.m2 + plan.m + plan.k,)
    np.testing.assert_allclose(tw[plan.m2 + plan.m + 3],
                               np.exp(-6j * np.pi / plan.k), rtol=0, atol=1e-15)
    assert fused.twiddle_table(fused.fft_plan(1 << 16)).shape == (
        fused.fft_plan(1 << 16).m2 + (1 << 15),)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1024, 4096, 16384, 32768, 65536, 131072,
                               262144])
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


@pytest.mark.cuda
def test_split_route_counts_launches(cuda):
    n, F, B = 1 << 17, 6, 2
    window, w_age = _plain_args(n, F, cuda)
    z = lambda *s: torch.zeros(s, device=cuda)  # noqa: E731
    before = (fused.launches, fused.split_launches)
    fused.fused_update(z(B, n), z(B, 2, n // 2), z(B, F, 2, n // 2),
                       torch.zeros(B, dtype=torch.int32, device=cuda),
                       z(B) + 10.2, z(B) + 0.3, z(B) + 0.05, window, w_age)
    torch.cuda.synchronize()
    assert (fused.launches, fused.split_launches) == (before[0], before[1] + 1)

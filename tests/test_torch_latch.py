"""The port's latch scan against the JAX package's Pallas latch scan.

``latch_scan_plain`` (the CPU path of ``latch_scan``) is held
BIT-IDENTICAL (``np.array_equal`` on every output row, sentinel rows
included) against ``build_latch_scan`` run in interpret mode: C in
{0, 4}, both scan directions, plane shapes off the kernel's (8, 128)
padding multiples. Keys are ``2*row + type`` as the interpreter's
first-hit walk builds them, with a column left without any event so the
scan stays at the sentinel there (where a row latches its OWN
candidate, as the Pallas kernel's Hillis-Steele ties do).

A numpy model of the CUDA kernel's chunked scan (chunk aggregates, a
carry scan from ``(sent, row -1)``, the rescan of each chunk from its
carry-in, super-blocks of 64 chunks carried in scan order) is held
bit-identical against both, over chunk heights from one row to the
whole plane, including keys that compare worse than the sentinel and
NaN keys.

Cases marked ``cuda`` hold the CUDA kernel (csrc/latch_scan.cu) against
the plain version on the card, also bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from glava_tpu.ops.pallas.latch import build_latch_scan
from glava_tpu_torch.ops import latch

SHAPES = [(97, 131), (129, 200), (10, 5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _sent(reverse: bool) -> float:
    # the interpreter's sentinels: suffix-min walks up, prefix-max down
    return float(np.float32(1 << 30)) if reverse else -1.0


def _inputs(shape, C, reverse, seed):
    """Keys ``2*row + type`` at random event cells, the sentinel
    elsewhere, the last column event-free; C random candidate planes."""
    rng = np.random.default_rng(seed)
    E, W = shape
    rows = np.arange(E, dtype=np.int64)[:, None]
    typ = rng.integers(0, 2, (E, W))
    event = rng.random((E, W)) < 0.15
    event[:, -1] = False
    key = np.where(event, 2 * rows + typ, _sent(reverse)).astype(np.float32)
    cands = tuple(rng.standard_normal((E, W)).astype(np.float32)
                  for _ in range(C))
    return key, cands


def _plane(kind, shape, C, reverse, seed):
    """``_inputs``, or with ``kind`` "worse" a third of the cells keyed
    worse than the sentinel (they never win against the start, so a row
    whose scan meets only those and sentinels latches 0.0 or its own
    sentinel tie), or with "nan" a fifth of the cells NaN (never wins)."""
    key, cands = _inputs(shape, C, reverse, seed)
    rng = np.random.default_rng(seed + 1)
    if kind == "worse":
        worse = np.float32(2.0 ** 31) if reverse else np.float32(-2.0)
        key = np.where(rng.random(shape) < 0.33, worse, key).astype(np.float32)
    elif kind == "nan":
        key = np.where(rng.random(shape) < 0.2, np.nan, key).astype(np.float32)
    return key, cands


CHUNKS = 64   # csrc/latch_scan.cu kChunks: chunks of one super-block


def _chunked_scan(key, cands, reverse, sent, L):
    """The CUDA kernel's decomposition in numpy, all columns at once:
    super-blocks of CHUNKS chunks of L rows in scan order; A: each
    chunk's aggregate (best key, latest row on ties, NaN while no row
    has come); B: each chunk's carry-in, the aggregates before it folded
    in scan order into the running pair from ``(sent, -1)`` (carried
    from one super-block to the next); C: the rescan of the chunk from
    its carry-in. Values are gathered at the winning row, 0.0 at row
    -1."""
    E, W = key.shape
    order = np.arange(E)[::-1] if reverse else np.arange(E)
    cols = np.arange(W)

    def wins(k, ref):
        return (k <= ref) if reverse else (k >= ref)

    okey = np.empty_like(key)
    outs = [np.empty_like(c) for c in cands]
    ck = np.full(W, np.float32(sent))
    cr = np.full(W, -1)
    with np.errstate(invalid="ignore"):
        for base in range(0, E, CHUNKS * L):
            chunks = [order[base + q * L:base + (q + 1) * L]
                      for q in range(CHUNKS)]
            aggs = []
            for rows in chunks:                     # A
                ak = np.full(W, np.nan, np.float32)
                ar = np.full(W, -1)
                for r in rows:
                    take = wins(key[r], ak) | np.isnan(ak)
                    ak = np.where(take, key[r], ak)
                    ar = np.where(take, r, ar)
                aggs.append((ak, ar))
            for rows, (ak, ar) in zip(chunks, aggs):
                ks, kr = ck, cr                     # C, from the carry-in
                for r in rows:
                    take = wins(key[r], ks)
                    ks = np.where(take, key[r], ks)
                    kr = np.where(take, r, kr)
                    okey[r] = ks
                    for c, cand in enumerate(cands):
                        outs[c][r] = np.where(kr >= 0,
                                              cand[np.maximum(kr, 0), cols], 0.0)
                take = wins(ak, ck)                 # B: fold the aggregate
                ck = np.where(take, ak, ck)
                cr = np.where(take, ar, cr)
    return (okey, *outs)


_PALLAS: dict = {}


def _pallas(key, cands, reverse, sent, ident):
    """build_latch_scan in interpret mode, once per input plane."""
    if ident not in _PALLAS:
        E, W = key.shape
        _PALLAS[ident] = [np.asarray(o) for o in build_latch_scan(
            E, W, len(cands), reverse, sent, interpret=True)(
            jnp.asarray(key), tuple(jnp.asarray(c) for c in cands))]
    return _PALLAS[ident]


PLANES = [("events", (1081, 64)), ("events", (97, 131)), ("events", (1, 7)),
          ("events", (7, 1)), ("worse", (97, 131)), ("nan", (97, 131))]


@pytest.mark.parametrize("height", [1, 3, 17, "E"])
@pytest.mark.parametrize("reverse", [True, False], ids=["suffix_min", "prefix_max"])
@pytest.mark.parametrize("C", [0, 4])
@pytest.mark.parametrize("plane", PLANES, ids=lambda p: f"{p[0]}-{p[1][0]}x{p[1][1]}")
def test_chunked_scan_model_is_bit_identical(plane, C, reverse, height):
    """The kernel's chunked decomposition equals the row-sequential
    plain version and the Pallas kernel bit for bit (NaN keys: the
    plain version only; the Pallas kernel's doubling tree does not
    define their order)."""
    kind, shape = plane
    seed = shape[0] + 3 * shape[1] + 7 * C + reverse
    key, cands = _plane(kind, shape, C, reverse, seed)
    sent = _sent(reverse)
    L = shape[0] if height == "E" else height
    got = _chunked_scan(key, cands, reverse, sent, L)
    plain = latch.latch_scan_plain(torch.as_tensor(key),
                                   tuple(torch.as_tensor(c) for c in cands),
                                   reverse, sent)
    for g, p in zip(got, plain):
        assert np.array_equal(g, p.numpy())
    if kind != "nan":
        for g, w in zip(got, _pallas(key, cands, reverse, sent,
                                     (kind, shape, C, reverse))):
            assert np.array_equal(g, w)
    if kind == "worse":
        # keys worse than the sentinel never win against the start, and
        # rows that meet only those latch 0.0
        worse = key > sent if reverse else key < sent
        assert worse.any() and not (worse & (got[0] == key)).any()
        if C:
            assert ((got[0] == sent) & (got[1] == 0.0)).any()


@pytest.mark.parametrize("reverse", [True, False], ids=["suffix_min", "prefix_max"])
@pytest.mark.parametrize("C", [0, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_matches_pallas_latch_scan(shape, C, reverse):
    key, cands = _inputs(shape, C, reverse, seed=shape[0] + 7 * C + reverse)
    sent = _sent(reverse)
    want = build_latch_scan(shape[0], shape[1], C, reverse, sent,
                            interpret=True)(
        jnp.asarray(key), tuple(jnp.asarray(c) for c in cands))
    got = latch.latch_scan(torch.as_tensor(key),
                           tuple(torch.as_tensor(c) for c in cands),
                           reverse, sent)
    assert len(got) == len(want) == 1 + C
    for g, w in zip(got, want):
        assert g.shape == shape and g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_sentinel_rows_latch_their_own_candidate():
    """Where the key scan stays at the sentinel, a row keeps its own
    candidate (not zeros, as build_latch_scan's docstring says): the
    Pallas kernel keeps the row's own value on a sentinel tie, and the
    port computes what the kernel computes."""
    key = np.full((10, 5), _sent(True), np.float32)
    key[4, 0] = 8.0
    cand = np.arange(50, dtype=np.float32).reshape(10, 5) + 1.0
    ks, lat = latch.latch_scan_plain(torch.as_tensor(key),
                                     (torch.as_tensor(cand),), True,
                                     _sent(True))
    stay = ks.numpy() == _sent(True)
    assert stay.sum() == 45
    np.testing.assert_array_equal(lat.numpy()[stay], cand[stay])
    np.testing.assert_array_equal(lat.numpy()[:5, 0], cand[4, 0])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_PLANES = [("events", s) for s in ((1081, 1920), (601, 800), (97, 131),
                                       (1, 7), (7, 1), (4097, 96))] + [
    ("worse", (1081, 1920)), ("nan", (601, 800))]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [True, False], ids=["suffix_min", "prefix_max"])
@pytest.mark.parametrize("C", [0, 4])
@pytest.mark.parametrize("plane", CARD_PLANES,
                         ids=lambda p: f"{p[0]}-{p[1][0]}x{p[1][1]}")
def test_kernel_matches_plain_on_card(cuda, plane, C, reverse):
    """One launch per call, bit-identical, on the walk's 1080p and
    800x600 planes, odd and degenerate shapes and a plane taller than
    one super-block (4097 rows)."""
    key, cands = _plane(*plane, C, reverse, seed=3)
    sent = _sent(reverse)
    k = torch.as_tensor(key, device=cuda)
    cs = tuple(torch.as_tensor(c, device=cuda) for c in cands)
    before = latch.launches[C]
    got = latch.latch_scan(k, cs, reverse, sent)
    torch.cuda.synchronize()
    assert latch.launches[C] == before + 1
    for g, w in zip(got, latch.latch_scan_plain(k, cs, reverse, sent)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    key = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError, match="C must be"):
        latch.latch_scan(key, (key,) * 2, True, 1.0)
    with pytest.raises(TypeError, match="float32"):
        latch.latch_scan(key.double(), (), True, 1.0)
    with pytest.raises(ValueError, match="shape"):
        latch.latch_scan(key, (torch.zeros((8, 9), device=cuda),) * 4, True, 1.0)

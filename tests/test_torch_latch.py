"""The port's latch scan against the JAX package's Pallas latch scan.

``latch_scan_plain`` (the CPU path of ``latch_scan``) is held
BIT-IDENTICAL (``np.array_equal`` on every output row, sentinel rows
included) against ``build_latch_scan`` run in interpret mode: C in
{0, 4}, both scan directions, plane shapes off the kernel's (8, 128)
padding multiples. Keys are ``2*row + type`` as the interpreter's
first-hit walk builds them, with a column left without any event so the
scan stays at the sentinel there (where a row latches its OWN
candidate, as the Pallas kernel's Hillis-Steele ties do).

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

@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [True, False], ids=["suffix_min", "prefix_max"])
@pytest.mark.parametrize("C", [0, 4])
@pytest.mark.parametrize("shape", [(1081, 1920), (97, 131)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_matches_plain_on_card(cuda, shape, C, reverse):
    key, cands = _inputs(shape, C, reverse, seed=3)
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

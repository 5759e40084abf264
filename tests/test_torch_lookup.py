"""The port's table lookup against the JAX package's Pallas lookups.

``table_lookup_plain`` (the CPU path of ``table_lookup`` and of
``StaticLookup``) is held BIT-EXACT against ``build_table_lookup`` and
``build_static_table_lookup`` run in interpret mode, on the small cases
of the JAX suite (tests/test_fused.py, tests/test_ops.py) and on the
radial and circle rasters' real 64x64 index planes. A lookup is pure
data movement, so the tolerance is zero.

Cases marked ``cuda`` hold the CUDA kernel (csrc/table_lookup.cu)
against the plain version on the card, also bit for bit.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from glava_tpu.config.glsl_shader import _fetch_1d as jfetch_1d
from glava_tpu.ops.pallas.lookup import (
    build_static_table_lookup, build_table_lookup,
)
from glava_tpu_torch.config import loader
from glava_tpu_torch.ops import lookup
from glava_tpu_torch.renderer import Renderer
from tests.test_golden import TINY_KNOBS, TINY_SCREEN


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_plain_matches_dense_pallas_lookup():
    """tests/test_fused.py's case: T, L, P off the 128 multiples."""
    rng = np.random.default_rng(5)
    T, L, P = 520, 3, 1000
    tab = rng.standard_normal(T).astype(np.float32)
    idx = rng.integers(0, T, (L, P)).astype(np.int32)
    want = build_table_lookup(L, T, P, tile_rows=4, interpret=True)(
        jnp.asarray(tab), jnp.asarray(idx))
    got = lookup.table_lookup(torch.as_tensor(tab), torch.as_tensor(idx))
    assert got.shape == (L, P) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


STATIC_CASES = {
    "multirow_coherent": ((3, 5000), 512, True),
    "small_dense": ((97,), 256, True),
    "large_coherent": ((2, 40000), 8192, True),
    "large_incoherent": ((2, 40000), 8192, False),
}


@pytest.mark.parametrize("case", sorted(STATIC_CASES))
def test_static_lookup_matches_static_pallas_lookup(case):
    """tests/test_ops.py's cases of the sorted-block static lookup."""
    shape, T, coherent = STATIC_CASES[case]
    rng = np.random.default_rng(7)
    idx = rng.integers(0, T, shape).astype(np.int32)
    if coherent:
        idx = np.sort(idx, axis=-1)
    tab = rng.random(T, dtype=np.float32)
    want = build_static_table_lookup(idx, T, interpret=True)(jnp.asarray(tab))
    got = lookup.StaticLookup(idx, T, "cpu")(torch.as_tensor(tab))
    assert got.shape == shape
    assert np.array_equal(got.numpy(), np.asarray(want))


def _module_lookup(module: str) -> lookup.StaticLookup:
    """The static lookup a module builds at the 64x64 tiny geometry."""
    with tempfile.TemporaryDirectory() as td:
        (Path(td) / f"{module}.glsl").write_text(TINY_KNOBS[module])
        lc = loader.load(cli_requests=(
            f"setgeometry 0 0 {TINY_SCREEN[0]} {TINY_SCREEN[1]}",
            "setbufsize 256", "setsamplesize 64", "setprintframes false"),
            force_module=module, user_dir=td)
    (lk,) = Renderer(lc, device="cpu").module.lookups
    return lk


@pytest.mark.parametrize("module", ["radial", "circle"])
def test_module_index_plane_matches_static_pallas_lookup(module):
    """radial's combined bar-id plane (64, 64) and circle's stacked
    (3, 64, 64) site planes, through both lookups."""
    lk = _module_lookup(module)
    idx = lk.idx.numpy()
    assert idx.shape == ((64, 64) if module == "radial" else (3, 64, 64))
    tab = np.random.default_rng(3).random(lk.table_size, dtype=np.float32)
    want = build_static_table_lookup(idx, lk.table_size, interpret=True)(
        jnp.asarray(tab))
    got = lk(torch.as_tensor(tab))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_table_rows_share_one_index_plane():
    """An (S, T) table gives (S, *idx.shape), row s from table s."""
    rng = np.random.default_rng(9)
    tabs = torch.as_tensor(rng.random((3, 300), dtype=np.float32))
    idx = torch.as_tensor(rng.integers(0, 300, (5, 7)).astype(np.int32))
    got = lookup.table_lookup(tabs, idx)
    assert got.shape == (3, 5, 7)
    for s in range(3):
        assert torch.equal(got[s], tabs[s][idx.long()])


def test_fetch_1d_matches_jax_texel_fetch():
    """Clipping into [0, sz - 1], then the gather; out-of-range and
    negative indices included."""
    rng = np.random.default_rng(11)
    sz = 256
    tex = rng.random(sz, dtype=np.float32)
    i = rng.integers(-40, sz + 40, (16, 9)).astype(np.int32)
    want = jfetch_1d(jnp.asarray(tex), jnp.asarray(i), sz)
    got = lookup.fetch_1d(torch.as_tensor(tex), torch.as_tensor(i), sz)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bad", [-1, 162])
def test_static_plane_out_of_range_raises_at_build(bad):
    idx = np.zeros((4, 4), np.int64)
    idx[2, 3] = bad
    with pytest.raises(ValueError, match=r"\[0, 162\)"):
        lookup.StaticLookup(idx, 162, "cpu")


def test_other_devices_raise():
    """Only CPU tensors take the plain version; a tensor elsewhere
    (here on the meta device) raises instead of falling back."""
    tab = torch.empty(16, device="meta")
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lookup.table_lookup(tab, idx)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_CASES = {
    "radial_162": ((600, 800), 162),
    "circle_8192": ((3, 1080, 1920), 8192),
    "dyn_smem_32768": ((2, 40000), 32768),
    "small_97": ((97,), 256),
    "ragged_1001": ((7, 143), 520),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(cuda, case):
    shape, T = CARD_CASES[case]
    rng = np.random.default_rng(13)
    idx = torch.as_tensor(rng.integers(0, T, shape).astype(np.int32), device=cuda)
    for tshape in ((T,), (3, T)):
        tab = torch.as_tensor(rng.standard_normal(tshape).astype(np.float32),
                              device=cuda)
        before = lookup.launches
        got = lookup.table_lookup(tab, idx)
        torch.cuda.synchronize()
        assert lookup.launches == before + 1
        assert torch.equal(got, lookup.table_lookup_plain(tab, idx))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    tab = torch.zeros(64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        lookup.table_lookup(tab, torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        lookup.table_lookup(tab.double(),
                            torch.zeros(4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="T <="):
        lookup.table_lookup(torch.zeros(lookup.MAX_TABLE + 1, device=cuda),
                            torch.zeros(4, dtype=torch.int32, device=cuda))

"""The port's table lookup against the JAX package's Pallas lookups.

``table_lookup_plain`` (the CPU path of ``table_lookup`` and of
``StaticLookup``) is held BIT-EXACT against ``build_table_lookup`` and
``build_static_table_lookup`` run in interpret mode, on the small cases
of the JAX suite (tests/test_fused.py, tests/test_ops.py) and on the
radial and circle rasters' real 64x64 index planes. A lookup is pure
data movement, so the tolerance is zero.

``rowwise_lookup_plain`` is held bit-exact against
``build_rowwise_lookup`` (C = 1) and ``build_rowwise_lookup_mc``
(C = 4) in interpret mode, with contiguous operands and with the
transposed views of (H, W) planes the interpreter hands over.

``rowwise_plan`` (which route and layout csrc/rowwise_lookup.cu takes)
is pinned as a function of the shapes and strides.

Cases marked ``cuda`` hold the CUDA kernels (csrc/table_lookup.cu,
csrc/rowwise_lookup.cu, each route) against the plain versions on the
card, also bit for bit.
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
    build_rowwise_lookup, build_rowwise_lookup_mc, build_static_table_lookup,
    build_table_lookup,
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


def _rowwise_inputs(N, T, P, C, transposed, seed=17):
    """C (N, T) tables and an (N, P) int32 index plane; ``transposed``
    makes each a ``.T`` view of a contiguous (T, N) / (P, N) array, as
    the interpreter passes the columns of (H, W) planes."""
    rng = np.random.default_rng(seed)
    if transposed:
        tabs = tuple(torch.as_tensor(rng.standard_normal((T, N))
                                     .astype(np.float32)).T for _ in range(C))
        idx = torch.as_tensor(rng.integers(0, T, (P, N)).astype(np.int32)).T
    else:
        tabs = tuple(torch.as_tensor(rng.standard_normal((N, T))
                                     .astype(np.float32)) for _ in range(C))
        idx = torch.as_tensor(rng.integers(0, T, (N, P)).astype(np.int32))
    return tabs, idx


@pytest.mark.parametrize("transposed", [False, True], ids=["contiguous", "T_views"])
@pytest.mark.parametrize("C", [1, 4])
def test_rowwise_plain_matches_pallas_rowwise_lookup(C, transposed):
    """tests/test_fused.py's case (N, T, P off the 8/128 multiples):
    C = 1 against build_rowwise_lookup, C = 4 against
    build_rowwise_lookup_mc."""
    N, T, P = 21, 300, 260
    tabs, idx = _rowwise_inputs(N, T, P, C, transposed)
    jt = tuple(jnp.asarray(t.numpy()) for t in tabs)
    ji = jnp.asarray(idx.numpy())
    if C == 1:
        want = (build_rowwise_lookup(N, T, P, interpret=True)(jt[0], ji),)
    else:
        want = build_rowwise_lookup_mc(N, T, P, C, interpret=True)(jt, ji)
    got = lookup.rowwise_lookup(tabs, idx)
    assert len(got) == C
    for g, w in zip(got, want):
        assert g.shape == (N, P) and g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_rowwise_plain_matches_interpreter_column_fetch():
    """The interpreter's column-aligned fetch: out[y, x] = plane[yi[y, x],
    x] through ``.T`` views of (H, W) planes and a (H, W) row plane."""
    rng = np.random.default_rng(23)
    H, W = 37, 53
    planes = [rng.random((H, W), dtype=np.float32) for _ in range(4)]
    yi = rng.integers(0, H, (H, W)).astype(np.int32)
    got = lookup.rowwise_lookup(tuple(torch.as_tensor(p).T for p in planes),
                                torch.as_tensor(yi).T)
    for g, p in zip(got, planes):
        assert np.array_equal(g.T.numpy(), np.take_along_axis(p, yi, axis=0))


@pytest.mark.parametrize("bad", [-1, 300])
def test_rowwise_out_of_range_raises(bad):
    tabs, idx = _rowwise_inputs(5, 300, 9, 1, False)
    idx[2, 3] = bad
    with pytest.raises(ValueError, match=r"\[0, 300\)"):
        lookup.rowwise_lookup(tabs, idx)


# (C, T, P, index strides, plan): the smoke's shapes (the colfetch fetch
# at 800x600 and 1920x1080 on .T views, contiguous operands, its odd and
# tall cases) and the edges of shared memory
ROWWISE_PLANS = [
    (4, 600, 600, (1, 800), lookup.RowwisePlan("staged", True, 16, 600, 115200)),
    (4, 1080, 1080, (1, 1920), lookup.RowwisePlan("staged", True, 16, 1080, 207360)),
    (1, 1080, 1080, (1, 1920), lookup.RowwisePlan("staged", True, 16, 1080, 138240)),
    (4, 1080, 1080, (1080, 1), lookup.RowwisePlan("staged", False, 16, 1080, 207360)),
    (1, 131, 131, (1, 97), lookup.RowwisePlan("staged", True, 16, 131, 16768)),
    (4, 1, 7, (1, 5), lookup.RowwisePlan("staged", True, 16, 7, 576)),
    (4, 1080, 1472, (1, 1920), lookup.RowwisePlan("staged", True, 16, 1472, 232448)),
    (4, 1080, 1473, (1, 1920), lookup.RowwisePlan("staged", True, 8, 1473, 116256)),
    (4, 2160, 2160, (1, 3840), lookup.RowwisePlan("staged", True, 8, 2160, 207360)),
    (4, 2160, 2944, (1, 3840), lookup.RowwisePlan("staged", True, 8, 2944, 232448)),
    (4, 2160, 2945, (1, 3840), lookup.RowwisePlan("direct", True, 16, 256, 0)),
    (1, 3632, 3632, (1, 96), lookup.RowwisePlan("staged", True, 8, 3632, 232448)),
    (1, 8192, 1000, (1, 96), lookup.RowwisePlan("direct", True, 16, 256, 0)),
    (4, 9001, 777, (777, 1), lookup.RowwisePlan("direct", False, 16, 256, 0)),
    (1, 8192, 20_000_000, (1, 96), lookup.RowwisePlan("direct", True, 16, 306, 0)),
]


@pytest.mark.parametrize("C,T,P,strides,plan", ROWWISE_PLANS,
                         ids=[f"C{c}-T{t}-P{p}-{'i' if s[0] < s[1] else 'j'}fast"
                              for c, t, p, s, _ in ROWWISE_PLANS])
def test_rowwise_plan_follows_the_shapes(C, T, P, strides, plan):
    """The kernel's route, lane order, band and shared memory, a pure
    function of (C, T, P, the index plane's strides): staged on a strip
    of 16 rows, else 8, while a strip's index plane and two table
    buffers (one at C = 1) fit in 227 KB, the direct route past it,
    bands that keep the grid within 65535 rows."""
    assert lookup.rowwise_plan(C, T, P, strides) == plan
    assert plan.smem == (4 * plan.strip * (P + min(C, 2) * T)
                         if plan.route == "staged" else 0)
    assert -(-P // plan.band) <= lookup.MAX_BANDS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_CASES = {
    "radial_162": ((600, 800), 162),
    "circle_8192": ((3, 1080, 1920), 8192),
    "dyn_smem_32768": ((2, 40000), 32768),
    "l2_131072": ((3, 50000), 131072),     # above MAX_TABLE: from the L2
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
    with pytest.raises(ValueError, match="T < 2"):
        lookup.table_lookup(torch.zeros(2, 3, 4, device=cuda),
                            torch.zeros(4, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["contiguous", "T_views"])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("shape", [(1920, 1080, 1080), (21, 300, 260),
                                   (97, 131, 131), (256, 2160, 2160),
                                   (96, 8192, 1000)],
                         ids=["1080p", "ragged", "97x131", "strip8", "direct"])
def test_rowwise_kernel_matches_plain_on_card(cuda, shape, C, transposed):
    """Both routes (the tall tables take the direct one) and both strip
    widths (2160 rows stage 8 at a time), both layouts, one launch on
    the planned route."""
    N, T, P = shape
    tabs, idx = _rowwise_inputs(N, T, P, C, transposed)
    tabs = tuple(t.to(cuda) for t in tabs)
    idx = idx.to(cuda)
    route = lookup.rowwise_plan(C, T, P, idx.stride()).route
    assert route == ("direct" if T == 8192 else "staged")
    before = lookup.rowwise_launches[C], lookup.rowwise_routes[route]
    got = lookup.rowwise_lookup(tabs, idx)
    torch.cuda.synchronize()
    assert (lookup.rowwise_launches[C], lookup.rowwise_routes[route]) == (
        before[0] + 1, before[1] + 1)
    for g, w in zip(got, lookup.rowwise_lookup_plain(tabs, idx)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["offset_views", "broadcast"])
@pytest.mark.parametrize("C", [1, 4])
def test_rowwise_kernel_strided_operands_on_card(cuda, C, layout):
    """.T views that start off a 16-byte boundary, and tables that are
    one plane column broadcast (row stride 0, the interpreter's const x
    pattern), at 1080p."""
    N, T, P = 1920, 1080, 1080
    rng = np.random.default_rng(29)
    planes = [torch.as_tensor(rng.standard_normal((T, N + 3)).astype(np.float32),
                              device=cuda) for _ in range(C)]
    yi = torch.as_tensor(rng.integers(0, T, (P, N + 5)).astype(np.int32),
                         device=cuda)[:, 5:]
    if layout == "offset_views":
        tabs = tuple(p[:, 3:].T for p in planes)
    else:
        tabs = tuple(p[:, 3:4].expand(T, N).T for p in planes)
    got = lookup.rowwise_lookup(tabs, yi.T)
    torch.cuda.synchronize()
    for g, w in zip(got, lookup.rowwise_lookup_plain(tabs, yi.T)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_rowwise_kernel_refuses_what_it_does_not_take(cuda):
    tab = torch.zeros((8, 16), device=cuda)
    idx = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="C must be"):
        lookup.rowwise_lookup((tab, tab), idx)
    with pytest.raises(TypeError, match="int32"):
        lookup.rowwise_lookup((tab,), idx.long())
    with pytest.raises(ValueError, match="expected"):
        lookup.rowwise_lookup((torch.zeros((9, 16), device=cuda),), idx)

"""The bars raster (``ops/raster.py``) against the JAX package.

The raster is comparisons and selects only, so every check here is bit
for bit (equal float32 bit patterns):

* at ``scripts/exp_pallas_bars.py``'s own 1920x1080 inputs, the plain
  version against the script's ``xla_raster`` (the shipped lowering)
  and its Pallas kernel ``pallas_raster`` run in interpret mode;
* on small random inputs (streams, outline widths, gap columns, shared
  and per-stream colours) against the JAX bars pass's masks;
* the port's bars pass at one stream against the JAX bars pass.

The kernel against the plain version needs the card (``cuda``-marked;
``chip_smoke.py`` runs the same check on the GPU).
"""

from __future__ import annotations

import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from glava_tpu.config import loader as jloader
from glava_tpu.render.base import PassInputs as JaxPassInputs
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu_torch.config import loader
from glava_tpu_torch.ops import raster
from glava_tpu_torch.render.base import PassInputs
from glava_tpu_torch.renderer import Renderer

ROOT = Path(__file__).resolve().parent.parent


def _script():
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_bars", ROOT / "scripts" / "exp_pallas_bars.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _port_hw4(v, inner, d, color, outline, bow=1.0, outlined=True):
    """The script's (W,), (H, 4) inputs through bars_raster_plain at one
    stream -> (H, W, 4) numpy, the script's layout."""
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    out = raster.bars_raster_plain(t(v)[None], t(inner), t(d), t(color)[None],
                                   t(outline)[None], bow, outlined)
    assert out.shape == (1, 4, len(d), len(v)) and out.dtype == torch.float32
    return out[0].permute(1, 2, 0).numpy()


@pytest.fixture(scope="module")
def script():
    return _script()


def test_plain_equals_xla_raster_at_1080p(script):
    ins = script.make_inputs(0)
    want = np.asarray(jax.jit(script.xla_raster)(*ins))
    got = _port_hw4(*ins, bow=script.BOW)
    assert got.shape == (script.H, script.W, 4)
    assert (got[..., 3] > 0).any()
    assert np.array_equal(_bits(got), _bits(want))


def test_plain_equals_pallas_raster_in_interpret_mode(script, monkeypatch):
    """The TPU kernel itself, run by Pallas's interpreter on the CPU
    (the script module's ``pl`` swapped for one whose ``pallas_call``
    interprets; the script is not edited)."""
    interp = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(script, "pl", interp)
    ins = script.make_inputs(1)
    want = np.asarray(script.pallas_raster(*ins))
    got = _port_hw4(*ins, bow=script.BOW)
    assert np.array_equal(_bits(got), _bits(want))


def _jax_masks(v, inner, d, color, outline, bow):
    """The JAX bars pass's raster (glava_tpu/render/modules/bars.py
    pass1, after the sample) for one stream -> (4, H, W)."""
    d_col = jnp.asarray(d)[:, None]
    v = jnp.asarray(v)
    inner_c = jnp.asarray(inner)
    body = d_col < (v - bow)[None, :]
    edge = d_col <= v[None, :]
    chans = []
    for c in range(4):
        out = jnp.float32(0.0)
        col = jnp.asarray(color[:, c])[:, None]
        rim = jnp.asarray(outline[:, c])[:, None]
        if bow > 0:
            out = jnp.where(edge & ~body, rim, out)
            out = jnp.where(body & ~inner_c[None, :], rim, out)
            out = jnp.where(body & inner_c[None, :], col, out)
        else:
            out = jnp.where(body, col, out)
        chans.append(jnp.broadcast_to(out, body.shape))
    return np.stack([np.asarray(c) for c in chans])


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_stream"])
@pytest.mark.parametrize("bow", [0.0, 1.0, 2.5])
@pytest.mark.parametrize("S", [1, 3])
def test_plain_equals_jax_pass_masks(S, bow, shared):
    rng = np.random.default_rng(S * 10 + int(bow * 2) + shared)
    H, W = 37, 53
    v = (rng.uniform(-5.0, 45.0, (S, W))).astype(np.float32)
    v[:, rng.random(W) < 0.3] = -np.inf            # gap / out-of-range columns
    v[:, 7] = np.float32(20.0)                      # rows right at the edges
    inner = rng.random(W) < 0.6
    d = (np.arange(H, dtype=np.float32) + 0.5)
    L = 1 if shared else S
    color = rng.uniform(0, 1, (L, H, 4)).astype(np.float32)
    outline = rng.uniform(0, 1.5, (L, H, 4)).astype(np.float32)
    got = raster.bars_raster(torch.as_tensor(v), torch.as_tensor(inner),
                             torch.as_tensor(d), torch.as_tensor(color),
                             torch.as_tensor(outline), bow, bow > 0)
    assert got.shape == (S, 4, H, W)
    for s in range(S):
        k = 0 if shared else s
        want = _jax_masks(v[s], inner, d, color[k], outline[k], bow)
        assert np.array_equal(_bits(got[s].numpy()), _bits(want))
    if bow > 0:
        assert (got[:, 3] > 0).any()


KNOBS = {
    "default": "",
    "no_outline": "#define BAR_OUTLINE_WIDTH 0\n#define BAR_WIDTH 3\n",
    "wide_outline": "#define BAR_OUTLINE_WIDTH 2\n#define BAR_WIDTH 7\n",
    "mirror_yx_flip": "#define MIRROR_YX 1\n#define FLIP 1\n",
    "invert_direction": "#define INVERT 1\n#define DIRECTION 1\n",
}


@pytest.mark.parametrize("variant", sorted(KNOBS))
def test_bars_pass_at_one_stream_equals_jax_pass(variant, tmp_path):
    """The port's bars pass1 (S = 1) against the JAX bars pass1 on the
    same textures: every channel plane bit for bit."""
    (tmp_path / "bars.glsl").write_text(KNOBS[variant])
    kw = dict(cli_requests=("setgeometry 0 0 96 64", "setprintframes false",
                            "setbufsize 1024", "setsamplesize 256"),
              force_module="bars", user_dir=tmp_path)
    r = Renderer(loader.load(**kw), device="cpu")
    jr = JaxRenderer(jloader.load(**kw))
    rng = np.random.default_rng(4)
    tex = {k: rng.uniform(0, 0.2, r.pipeline.sz).astype(np.float32)
           for k in ("audio_l", "audio_r")}
    got = r.module.passes[0](PassInputs(
        None, {k: torch.as_tensor(v)[None] for k, v in tex.items()}, 0.0))
    want = jr.module.passes[0](JaxPassInputs(
        None, {k: jnp.asarray(v) for k, v in tex.items()}, jnp.float32(0.0)))
    assert len(got) == len(want) == 4
    drawn = False
    for g, w in zip(got, want):
        w = np.broadcast_to(np.asarray(w), (64, 96))
        assert g.shape == (1, 64, 96)
        assert np.array_equal(_bits(g[0].numpy()), _bits(w))
        drawn |= bool((w > 0).any())
    assert drawn


def test_wrapper_refuses_other_devices():
    t = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        raster.bars_raster(t, torch.zeros(4, dtype=torch.bool, device="meta"),
                           torch.zeros(2, device="meta"),
                           torch.zeros((1, 2, 4), device="meta"),
                           torch.zeros((1, 2, 4), device="meta"), 1.0, True)


@pytest.mark.cuda
@pytest.mark.parametrize("outlined", [True, False])
@pytest.mark.parametrize("S,H,W,shared", [(64, 600, 800, False),
                                          (3, 1080, 1920, True),
                                          (1, 1920, 1080, False)])
def test_cuda_kernel_equals_plain(S, H, W, shared, outlined):
    """On the card the kernel equals the plain version bit for bit
    (torch.equal), and counts its launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(9)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    v = rng.uniform(-10.0, H, (S, W)).astype(np.float32)
    v[:, rng.random(W) < 0.2] = -np.inf
    L = 1 if shared else S
    args = (t(v), t(rng.random(W) < 0.6),
            t(np.arange(H, dtype=np.float32) + 0.5),
            t(rng.random((L, H, 4)).astype(np.float32)),
            t(rng.random((L, H, 4)).astype(np.float32)), 1.0, outlined)
    before = raster.launches
    got = raster.bars_raster(*args)
    want = raster.bars_raster_plain(*args)
    torch.cuda.synchronize()
    assert raster.launches == before + 1
    assert torch.equal(got, want)

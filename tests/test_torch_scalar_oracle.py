"""The port's vectorized interpreter against the per-pixel scalar oracle.

Each shader renders through ``glava_tpu_torch``'s masked-plane executor
(``Renderer`` on the CPU, every pass's planes kept), then
``tests/scalar_oracle.ScalarExec`` re-executes the same source at
sampled pixels with real Python control flow, on the port's own
textures and previous-pass frames. The oracle walks the JAX package's
parse of the same files (it is written against that AST); execution,
where masking faults would live, shares nothing with the port.

The shaders are the JAX suite's (``tests/test_scalar_oracle_differential.py``):
the control-flow composite, the two-pass walk, and the shipped
``docs/examples/rings`` module. Bound: the suite's for sampled pixels,
at most 5% of them more than 5e-4 off (float32 against the oracle's
float64 can cross a threshold at a boundary pixel).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from glava_tpu.config import loader as jloader
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu_torch.config import loader
from glava_tpu_torch.render.base import PassInputs, as_planes, clip_planes, interleave
from glava_tpu_torch.renderer import Renderer
from tests.scalar_oracle import ScalarExec
from tests.test_scalar_oracle_differential import (
    CONTROL_FRAG, WALK_FRAG_1, WALK_FRAG_2,
)

RINGS = Path(__file__).resolve().parent.parent / "docs" / "examples" / "rings"
SHADERS = {
    "ctl": lambda: [CONTROL_FRAG],
    "wk": lambda: [WALK_FRAG_1, WALK_FRAG_2],
    "rings": lambda: [(RINGS / "1.frag").read_text(),
                      (RINGS / "2.frag").read_text()],
}


def _write(tmp_path: Path, name: str, frags: list, screen=(48, 36)) -> Path:
    mod = tmp_path / name
    mod.mkdir(parents=True)
    for i, frag in enumerate(frags, 1):
        (mod / f"{i}.frag").write_text(frag)
    (tmp_path / "rc.glsl").write_text(
        f"#request mod {name}\n"
        f"#request setgeometry 0 0 {screen[0]} {screen[1]}\n"
        "#request setbufsize 1024\n#request setsamplesize 256\n"
        "#request setprintframes false\n"
    )
    return tmp_path


def _port_passes(lc):
    """The port's per-pass (H, W, 4) float32 frames and the textures
    they read, from one update of seeded audio."""
    r = Renderer(lc, device="cpu")
    rng = np.random.default_rng(5)
    snap = rng.standard_normal((2, lc.cfg.bufsize)).astype(np.float32) * 0.3
    g = float(np.float32(lc.cfg.gravity_step / lc.cfg.nominal_ups))
    key = r.init_state().key_end.new_tensor(snap)
    chains = r.pipeline.advance(r.pipeline.init_state(), key[0], key[1],
                                gravity_g=g)
    textures = r.pipeline.textures_from(chains, key[0], key[1])
    w, h = r.screen
    outs, out = [], None
    for fn in r.module.passes:
        out = clip_planes(as_planes(fn(PassInputs(out, textures, 0.1))))
        outs.append(interleave(out, h, w, "cpu").numpy())
    return outs, {k: v.numpy() for k, v in textures.items()}


@pytest.mark.parametrize("name", list(SHADERS))
def test_port_interpreter_matches_scalar_oracle(name, tmp_path):
    d = _write(tmp_path, name, SHADERS[name]())
    outs, tex = _port_passes(loader.load(user_dir=d))
    # the oracle's AST, uniforms and defines: the JAX parse of the files
    jpasses = JaxRenderer(jloader.load(user_dir=d)).module.passes
    assert len(jpasses) == len(outs) == len(SHADERS[name]())
    h, w = outs[0].shape[:2]
    rng = np.random.default_rng(9)
    xs, ys = rng.integers(0, w, 40), rng.integers(0, h, 40)
    sz = next(iter(tex.values())).shape[-1]
    bad = total = 0
    for pi, fn in enumerate(jpasses):
        prev = outs[pi - 1] if pi else None
        for x, y in zip(xs, ys):
            ex = ScalarExec(fn.program, x=int(x), y=int(y), textures=tex,
                            prev=prev, screen=(w, h), sz=sz,
                            defines=fn.defines, uniforms=fn.uniforms)
            got = np.clip(np.asarray(ex.run_main(), np.float64), 0.0, 1.0)
            want = outs[pi][int(y), int(x)].astype(np.float64)
            bad += not np.allclose(got, want, atol=5e-4)
            total += 1
    assert bad <= total * 0.05, f"{bad}/{total} sampled pixels diverge"
    assert (outs[-1][..., 3] > 0).any()

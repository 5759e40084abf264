"""User GLSL shader modules through the port's interpreter, held against
the JAX package's.

The same shader module directory renders through the JAX ``Renderer``
(its jitted, quantized step) and the port's ``Renderer`` on the CPU,
from the same numpy PCM, and the uint8 frames meet the golden rule:
under 0.2% of pixels more than 2 LSB apart. The shaders are the JAX
suite's own (tests/test_glsl_shader.py, tests/test_walk_fuzz.py,
tests/test_interp_fuzz.py, tests/test_halo_fuzz.py,
docs/examples/rings) and chip_smoke.py's
``SHADER_MODULES``. On the CPU every kernel runs as its plain version,
so the routes the interpreter takes are pinned by its route counters
(``_WALK_HITS``, ``_LATCH_HITS``, ``_PROV_HITS``) and by counting the
calls of the kernel wrappers a frame, which chip_smoke.py's
``LAUNCHES`` table states for the card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import chip_smoke
from glava_tpu.config import loader as jloader
from glava_tpu.renderer import Renderer as JaxRenderer
from glava_tpu_torch import interop
from glava_tpu_torch.config import glsl_shader, loader
from glava_tpu_torch.config.glsl_shader import ShaderError
from glava_tpu_torch.ops import latch, lookup
from glava_tpu_torch.renderer import Renderer
from tests.test_glsl_shader import (
    DIM_FRAG, EQ_FRAG, LATCH_ADJ_FRAG2, MAT_FRAG, SWITCH_FRAG, WALK_FRAG2,
)
from tests.test_halo_fuzz import PASS1 as TAP_BASE, gen_tap_frag
from tests.test_interp_fuzz import Gen
from tests.test_walk_fuzz import BASE as WALK_BASE, gen_walk_frag

ROOT = Path(__file__).resolve().parent.parent
RINGS = ROOT / "docs" / "examples" / "rings"


def golden_fraction(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    return float((np.abs(got.astype(np.int16) - want.astype(np.int16)) > 2).mean())


def _write(root: Path, name: str, frags, screen, requests=()) -> Path:
    mod = root / name
    mod.mkdir(parents=True)
    for i, src in enumerate(frags, start=1):
        (mod / f"{i}.frag").write_text(src)
    (root / "rc.glsl").write_text(
        f"#request mod {name}\n#request setgeometry 0 0 {screen[0]} {screen[1]}\n"
        "#request setbufsize 1024\n#request setsamplesize 256\n"
        "#request setprintframes false\n"
        + "".join(f"#request {r}\n" for r in requests))
    return root


def _snaps(n: int, seed: int = 0, amp: float = 0.3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 1024)) * amp).astype(np.float32)
            for _ in range(n)]


def render_both(root: Path, n: int = 3, seed: int = 0):
    """The final uint8 frames of ``n`` updates through both packages."""
    jr = JaxRenderer(jloader.load(user_dir=root))
    pr = Renderer(loader.load(user_dir=root), device="cpu")
    step = jr.jit_step(quantize=True)
    js, ps = jr.init_state(), pr.init_state()
    g = np.float32(0.05)
    for snap in _snaps(n, seed):
        js, want = step(js, jnp.asarray(snap), True, np.float32(0.25),
                        np.float32(1.0), g, {})
        ps, got = pr.step_u8(ps, snap, True, 0.25, 1.0, float(g))
    return np.asarray(want), got.numpy()


# inline shaders of tests/test_glsl_shader.py (the while, return,
# continue, discard and derivative cases), at the sizes used here
INLINE = {
    "while_masked": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "  float acc = 0.0;\n  float i = 0.0;\n"
        "  while (i < gl_FragCoord.x) {\n    acc += 2.0;\n    i += 1.0;\n"
        "    if (acc > 10.0) break;\n  }\n"
        "  fragment = vec4(acc / 16.0, 0, 0, 1);\n}\n"),
    "arrays_do_while": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "  float a[3];\n  a[0] = 1.0; a[1] = 2.0; a[2] = 4.0;\n"
        "  float b[] = float[](0.125, 0.25, 0.5);\n"
        "  float idx = mod(gl_FragCoord.x - 0.5, 3.0);\n  float n = 0.0;\n"
        "  do { n += 1.0; } while (n < a[idx]);\n"
        "  fragment = vec4(a[idx] / 8.0, b[int(idx)], n / 8.0, 1);\n}\n"),
    "discard": (
        "in vec4 gl_FragCoord;\n#request uniform \"screen\" screen\n"
        "uniform ivec2 screen;\nout vec4 fragment;\nvoid main() {\n"
        "  if (gl_FragCoord.x < screen.x / 2) discard;\n"
        "  fragment = vec4(1, 0, 0, 1);\n}\n"),
    "dynamic_for": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "  float acc = 0.0;\n"
        "  for (int i = 0; i < gl_FragCoord.x / 8.0; i++) { acc += 0.125; }\n"
        "  fragment = vec4(acc / 8.0, 0, 0, 1);\n}\n"),
    "helper_early_returns": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\n"
        "float pick(float x) {\n  if (x < 8.0) {\n    return 0.25;\n  }\n"
        "  if (x < 16.0) return 0.5;\n  return 1.0;\n}\n"
        "void main() {\n  float v = pick(gl_FragCoord.x);\n"
        "  fragment = vec4(v, 0, 0, 1);\n}\n"),
    "continue_dynamic_for": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "  float q = 0.0;\n  float n = gl_FragCoord.y - 0.5 + 3.0;\n"
        "  for (int i = 0; i < n; i += 1) {\n    if (i == 1) continue;\n"
        "    q += 0.01;\n  }\n  fragment = vec4(q, 0, 0, 1);\n}\n"),
    "continue_do_while": (
        "out vec4 fragment;\nvoid main() {\n  float k = 0.0;\n"
        "  float z = 0.0;\n  do {\n    k += 1.0;\n"
        "    if (k == 2.0) continue;\n    z += 1.0;\n  } while (k < 2.0);\n"
        "  fragment = vec4(k / 8.0, z / 8.0, 0, 1);\n}\n"),
    "global_write_in_while": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nfloat g = 0.0;\n"
        "void bump() { g += 0.0125; }\nvoid main() {\n  float j = 0.0;\n"
        "  while (j < gl_FragCoord.x) {\n    j += 1.0;\n    bump();\n  }\n"
        "  fragment = vec4(g, 0, 0, 1);\n}\n"),
    "global_write_in_condition": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nfloat g = 0.0;\n"
        "float nextv() { g += 1.0; return g; }\nvoid main() {\n"
        "  while (nextv() < gl_FragCoord.x) { }\n"
        "  fragment = vec4(g / 80.0, 0, 0, 1);\n}\n"),
    "return_inside_while": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "  fragment = vec4(0, 0, 0, 1);\n  float i = 0.0;\n"
        "  while (i < gl_FragCoord.x) {\n    i += 1.0;\n"
        "    if (i >= 3.0) {\n      fragment = vec4(1, 0, 0, 1);\n"
        "      return;\n    }\n  }\n  fragment = vec4(0, 1, 0, 1);\n}\n"),
    "valued_return_in_helper": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\n"
        "float walk(float limit) {\n  float i = 0.0;\n"
        "  while (i < 100.0) {\n    i += 1.0;\n"
        "    if (i >= limit) return i * 0.01;\n  }\n  return 0.99;\n}\n"
        "void main() {\n  fragment = vec4(walk(gl_FragCoord.x), 0, 0, 1);\n}\n"),
    "return_nested_while": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "  fragment = vec4(0, 0, 0, 1);\n  float o = 0.0;\n"
        "  while (o < gl_FragCoord.x) {\n    float i = 0.0;\n"
        "    while (i < gl_FragCoord.y) {\n      i += 1.0;\n"
        "      if (o + i >= 40.0) { fragment.r = 1.0; return; }\n    }\n"
        "    o += 1.0;\n  }\n  fragment.g = 1.0;\n}\n"),
    "switch_continue": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "    float acc = 0;\n    for (int i = 0; i < 6; i += 1) {\n"
        "        switch (i % 3) {\n        case 0: continue;\n"
        "        case 1: acc += 1.0; break;\n        default: acc += 10.0;\n"
        "        }\n        acc += 100.0;\n    }\n"
        "    fragment = vec4(acc / 1000.0, 0, 0, 1);\n}\n"),
    "switch_while_carry": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "    float acc = 0.0;\n    float i = 0.0;\n"
        "    float limit = gl_FragCoord.x + 0.5;\n    while (i < limit) {\n"
        "        switch (int(mod(i, 2.0))) {\n        case 0: acc += 1.0; break;\n"
        "        default: acc += 10.0;\n        }\n        i += 1.0;\n    }\n"
        "    fragment = vec4(acc / 400.0, i / 100.0, 0, 1);\n}\n"),
    "dfdx_dfdy_fwidth": (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "  float v = gl_FragCoord.x * gl_FragCoord.x * 0.004\n"
        "          + gl_FragCoord.y * 0.05;\n"
        "  fragment = vec4(dFdx(v), dFdy(v), fwidth(v) * 0.5, 1);\n}\n"),
}

CASES = {
    "eq_dim": ((EQ_FRAG, DIM_FRAG), (64, 32)),
    "eq_only": ((EQ_FRAG,), (96, 64)),
    "switch": ((SWITCH_FRAG,), (64, 32)),
    "mat": ((MAT_FRAG,), (64, 32)),
    "walk": ((EQ_FRAG, WALK_FRAG2), (96, 64)),
    # smooth_audio through the presmoothed texture, and mono input
    "walk_no_smooth_pass": ((EQ_FRAG, WALK_FRAG2), (96, 64),
                            ("setsmoothpass false",)),
    "walk_mirror": ((EQ_FRAG, WALK_FRAG2), (96, 64), ("setmirror true",)),
    "latch_adj": ((EQ_FRAG, LATCH_ADJ_FRAG2), (96, 64)),
    "rings": (tuple((RINGS / f"{i}.frag").read_text() for i in (1, 2)),
              (96, 64)),
    **{k: ((v,), (64, 32)) for k, v in INLINE.items()},
    **{f"smoke_{k}": (f(), (192, 128))
       for k, f in chip_smoke.SHADER_MODULES.items() if k != "rings"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_shader_module_meets_jax_frame(tmp_path, case):
    frags, screen, *requests = CASES[case]
    want, got = render_both(_write(tmp_path, "m", frags, screen,
                                   *requests))
    assert got.shape == (screen[1], screen[0], 4)
    assert golden_fraction(got, want) < 0.002


@pytest.mark.parametrize("seed", range(8))
def test_walk_fuzz_meets_jax_frame(tmp_path, seed):
    """tests/test_walk_fuzz.py's generator (its first pass declares the
    chain ``window, fft``, which the pipeline runs as any fft chain)."""
    frag2 = gen_walk_frag(np.random.default_rng(9000 + seed))
    want, got = render_both(_write(tmp_path, "eq", (WALK_BASE, frag2),
                                   (64, 48)))
    assert golden_fraction(got, want) < 0.002


@pytest.mark.parametrize("seed", range(8))
def test_interp_fuzz_meets_jax_frame(tmp_path, seed):
    """tests/test_interp_fuzz.py's random programs (nested control
    flow, arrays with run-time indices, switch, helpers with inout
    params, structs with aggregate ``==``)."""
    frag = Gen(np.random.default_rng(4000 + seed)).program()
    want, got = render_both(_write(tmp_path, "fz", (frag,), (64, 32)))
    assert golden_fraction(got, want) < 0.002


@pytest.mark.parametrize("seed", range(8))
def test_tap_fuzz_meets_jax_frame(tmp_path, seed):
    """tests/test_halo_fuzz.py's neighbour taps of prev at offsets in
    [-3, 3]: shifts, truncate-toward-zero clamps and the 2-D gather."""
    frag2 = gen_tap_frag(np.random.default_rng(7000 + seed))
    want, got = render_both(_write(tmp_path, "tap", (TAP_BASE, frag2),
                                   (64, 32)))
    assert golden_fraction(got, want) < 0.002


class _Spy:
    """Counts the calls of the kernel wrappers and the channels each
    call carries (on the CPU each call is the plain version)."""

    def __init__(self, monkeypatch):
        self.rowwise, self.latch, self.table = [], [], 0
        rw, lt, tl = lookup.rowwise_lookup, latch.latch_scan, lookup.table_lookup

        def rowwise(tabs, idx):
            tabs = tuple(tabs)
            self.rowwise.append(len(tabs))
            return rw(tabs, idx)

        def latch_scan(key, cands, reverse, sent):
            cands = tuple(cands)
            self.latch.append(len(cands))
            return lt(key, cands, reverse, sent)

        def table(tab, idx):
            self.table += 1
            return tl(tab, idx)

        monkeypatch.setattr(lookup, "rowwise_lookup", rowwise)
        monkeypatch.setattr(latch, "latch_scan", latch_scan)
        monkeypatch.setattr(lookup, "table_lookup", table)


# route counter increments a frame, and the kernel-wrapper calls a
# frame with their channel counts
ROUTES = {
    "aawalk": ((3, 2, 2), [], [0, 0, 4, 4]),
    "colfetch": ((1, 0, 1), [4, 4], [0]),
    "rings": ((0, 0, 0), [], []),
}


@pytest.mark.parametrize("module", sorted(ROUTES))
def test_routes_fire_and_match_the_stated_launches(tmp_path, monkeypatch, module):
    """The anti-alias walk takes the key scan and the latch, the
    column fetch both row-wise lookup routes; the wrapper calls a frame
    are chip_smoke.LAUNCHES, the counts the card must show."""
    chip_smoke.write_shader_modules(tmp_path)
    r = Renderer(loader.load(user_dir=tmp_path, force_module=module,
                             cli_requests=("setgeometry 0 0 96 64",
                                           "setbufsize 1024")), device="cpu")
    state = r.init_state()
    snaps = _snaps(3, seed=2)
    state, _ = r.step_u8(state, snaps[0], True, 0.0, 1.0, 0.05)
    spy = _Spy(monkeypatch)
    hits = (glsl_shader._WALK_HITS[0], glsl_shader._LATCH_HITS[0],
            glsl_shader._PROV_HITS[0])
    _, frame = r.step_u8(state, snaps[1], True, 0.0, 1.0, 0.05)
    moved = tuple(b - a for a, b in zip(hits, (
        glsl_shader._WALK_HITS[0], glsl_shader._LATCH_HITS[0],
        glsl_shader._PROV_HITS[0])))
    want_hits, want_rw, want_lt = ROUTES[module]
    assert moved == want_hits
    assert sorted(spy.rowwise) == sorted(want_rw)
    assert sorted(spy.latch) == sorted(want_lt)
    stated = chip_smoke.LAUNCHES[module]
    for C in (1, 4):
        assert spy.rowwise.count(C) == stated.get(f"rowwise_lookup C={C}", 0)
    for C in (0, 4):
        assert spy.latch.count(C) == stated.get(f"latch_scan C={C}", 0)
    assert spy.table == stated.get("table_lookup", 0)
    assert (frame.numpy()[..., 3] > 0).any()


def test_jax_state_carries_into_shader_module(tmp_path):
    """A few JAX steps of a shader module, its state carried through
    ``interop``, then one more step in each package: the frames meet
    the golden rule."""
    root = _write(tmp_path, "eq", (EQ_FRAG, DIM_FRAG), (64, 32))
    jr = JaxRenderer(jloader.load(user_dir=root))
    pr = Renderer(loader.load(user_dir=root), device="cpu")
    step = jr.jit_step(quantize=True)
    js = jr.init_state()
    g = np.float32(0.05)
    snaps = _snaps(5, seed=3)
    for snap in snaps[:4]:
        js, _ = step(js, jnp.asarray(snap), True, np.float32(0.25),
                     np.float32(1.0), g, {})
    ps = interop.state_from_jax_numpy(jax.tree.map(np.asarray, js),
                                      pr.cfg, "cpu")
    _, want = step(js, jnp.asarray(snaps[4]), True, np.float32(0.25),
                   np.float32(1.0), g, {})
    _, got = pr.step_u8(ps, snaps[4], True, 0.25, 1.0, float(g))
    assert (got.numpy()[..., 3] > 0).any()
    assert golden_fraction(got.numpy(), np.asarray(want)) < 0.002


def test_exec_errors_cite_source_line(tmp_path):
    root = _write(tmp_path, "bad", (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "    float ok = 1.0;\n"
        "    fragment = vec4(undefined_name_xyz, 0, 0, 1);\n}\n",), (64, 32))
    r = Renderer(loader.load(user_dir=root), device="cpu")
    with pytest.raises(ShaderError) as ei:
        r.step_u8(r.init_state(), _snaps(1)[0], True, 0.0, 1.0, 0.05)
    msg = str(ei.value)
    assert "1.frag" in msg and ":5:" in msg and "undefined_name_xyz" in msg


def test_fuel_exhaustion_warns_and_strict_raises(tmp_path, monkeypatch, capfd):
    root = _write(tmp_path, "fuel", (
        "in vec4 gl_FragCoord;\nout vec4 fragment;\nvoid main() {\n"
        "  float i = 0.0;\n  while (i >= 0.0) { i += 1.0; }\n"
        "  fragment = vec4(i * 0.1, 0, 0, 1);\n}\n",), (64, 32))
    monkeypatch.setenv("GLAVA_TPU_WHILE_FUEL", "7")
    monkeypatch.setitem(glsl_shader._FUEL_WARN_STATE, "last", 0.0)
    r = Renderer(loader.load(user_dir=root), device="cpu")
    _, f = r.step_u8(r.init_state(), _snaps(1)[0], True, 0.0, 1.0, 0.05)
    assert "fuel cap (7) exhausted with 2048 pixel(s)" in capfd.readouterr().err
    np.testing.assert_allclose(f.numpy()[..., 0], round(0.7 * 255), atol=1)
    monkeypatch.setenv("GLAVA_TPU_WHILE_FUEL_STRICT", "1")
    with pytest.raises(RuntimeError, match="fuel cap"):
        r.step_u8(r.init_state(), _snaps(1)[0], True, 0.0, 1.0, 0.05)


def test_shader_dir_shadows_builtin_module(tmp_path):
    """A user ``bars/1.frag`` shadows the built-in bars module
    (user-over-system path order), in this load only."""
    root = _write(tmp_path, "bars", (
        "out vec4 fragment;\nvoid main() { fragment = vec4(0, 0, 1, 1); }\n",),
        (16, 16))
    r = Renderer(loader.load(user_dir=root), device="cpu")
    _, f = r.step_u8(r.init_state(), _snaps(1)[0], True, 0.0, 1.0, 0.05)
    assert (f.numpy() == [0, 0, 255, 255]).all()
    assert "bars" not in loader.load().module_overrides


def test_cli_runs_a_shader_module_on_cpu(tmp_path):
    """``python -m glava_tpu_torch --device cpu --config-dir <dir> -m
    rings --frames 5 --sink null`` exits 0."""
    (tmp_path / "rings").mkdir()
    for i in (1, 2):
        (tmp_path / "rings" / f"{i}.frag").write_text(
            (RINGS / f"{i}.frag").read_text())
    proc = subprocess.run(
        [sys.executable, "-m", "glava_tpu_torch", "--device", "cpu",
         "--config-dir", str(tmp_path), "-m", "rings", "--size", "128x96",
         "--frames", "5", "--sink", "null"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

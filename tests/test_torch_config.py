"""The port's configuration layer against the JAX package's.

The loader must give the same ``RenderConfig`` and defines. The knob
expression evaluator must give exactly the JAX package's results on
numpy inputs (both run the same numpy code), and agree within 1e-6 on
torch versus jnp inputs (both float32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from glava_tpu.config import glsl_expr as jexpr
from glava_tpu.config import loader as jloader
from glava_tpu_torch.config import glsl_expr, loader

BARS_KNOBS = {
    "GRADIENT": "80",
    "COLOR": "@fg:mix(#3366b2, #a0a0b2, clamp(d / GRADIENT, 0, 1))",
    "BAR_OUTLINE": "@bg:vec4(COLOR.rgb * 1.5, COLOR.a)",
}

# a sample of builtins across the dispatch kinds (exact, transcendental,
# integer, relational, vector)
BUILTINS = [
    "floor(d * 0.37) + fract(d * 0.1) - mod(d, 7.0)",
    "step(20.0, d) + smoothstep(5.0, 60.0, d)",
    "sin(d * 0.05) * cos(d * 0.02) + sqrt(d) + exp(-d / 50.0)",
    "pow(d / 100.0 + 1.0, 1.5) + atan(d, 40.0) + log(d + 1.0)",
    "length(vec2(d, 3.0)) + dot(vec3(d, 1.0, 2.0), vec3(0.5))",
    "clamp(d / 30.0, 0.2, 0.8) + max(d, 12.0) - min(d, 40.0)",
    "abs(d - 50.0) + sign(d - 50.0) + trunc(d / 3.0) + round(d / 4.0)",
    "(d > 30.0 ? 1.0 : 0.25) * mix(2.0, 4.0, d / 100.0)",
    "float(int(d) & 7) + float(int(d) >> 2)",
]


@pytest.mark.parametrize("case", ["shipped", "bars_small", "requests"])
def test_loader_matches_jax(case):
    kwargs = {}
    if case == "bars_small":
        kwargs = dict(cli_requests=("setgeometry 0 0 192 128", "setbufsize 256",
                                    "setsamplesize 64"), force_module="bars")
    elif case == "requests":
        kwargs = dict(cli_requests=("setfftscale 12.5", "setgravitystep 3.0",
                                    "setavgframes 4", "setopacity \"xroot\"",
                                    "setbg 20304050"))
    got = loader.load(**kwargs)
    want = jloader.load(**kwargs)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.defines == want.defines
    assert got.module == want.module
    assert got.entry_path == want.entry_path
    assert got.env.variables == want.env.variables


def test_shipped_config_is_the_main_path():
    cfg = loader.load().cfg
    assert (cfg.module, cfg.geometry[2:], cfg.bufsize, cfg.samplesize) == \
        ("bars", (800, 600), 4096, 1024)
    assert cfg.accel_fft and cfg.smooth_pass


def test_user_knob_file_loads(tmp_path):
    (tmp_path / "bars.glsl").write_text("#define BAR_WIDTH 9\n")
    got = loader.load(user_dir=tmp_path, force_module="bars")
    want = jloader.load(user_dir=tmp_path, force_module="bars")
    assert got.defines["BAR_WIDTH"] == want.defines["BAR_WIDTH"] == "9"


@pytest.mark.parametrize("kind", ["python", "shader"])
def test_user_modules_are_not_yet_ported(tmp_path, kind):
    """User modules register into the load's own override map, as in
    the JAX loader: a user Python module that registers nothing leaves
    it empty in both loaders, one that imports jax is refused by name
    before it runs; a user shader directory registers as a module of
    this load."""
    if kind == "python":
        (tmp_path / "modules").mkdir()
        (tmp_path / "modules" / "mine.py").write_text("")
        got = loader.load(user_dir=tmp_path)
        want = jloader.load(user_dir=tmp_path)
        assert got.module_overrides == {} and want.module_overrides == {}
        (tmp_path / "modules" / "mine.py").write_text(
            "import jax.numpy as jnp\nraise SystemExit('ran')\n")
        with pytest.raises(ValueError, match=r"mine\.py' imports jax\.numpy"):
            loader.load(user_dir=tmp_path)
        return
    (tmp_path / "mine").mkdir()
    (tmp_path / "mine" / "1.frag").write_text("")
    got = loader.load(user_dir=tmp_path)
    want = jloader.load(user_dir=tmp_path)
    assert sorted(got.module_overrides) == sorted(want.module_overrides) \
        == ["mine"]
    assert got.module_overrides["mine"][1] == want.module_overrides["mine"][1]


def _env(mod, d):
    return mod.Env(defines=dict(BARS_KNOBS), variables={"d": d})


def _flat(v):
    return [np.asarray(c) for c in (v if isinstance(v, tuple) else (v,))]


@pytest.mark.parametrize("expr", ["COLOR", "BAR_OUTLINE"] + BUILTINS)
def test_numpy_results_equal_jax_exactly(expr):
    d = (np.arange(120, dtype=np.float64) + 0.5)[:, None]
    got = glsl_expr.evaluate(expr, _env(glsl_expr, d))
    want = jexpr.evaluate(expr, _env(jexpr, d))
    for a, b in zip(_flat(got), _flat(want), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("expr", ["COLOR", "BAR_OUTLINE"] + BUILTINS)
def test_torch_agrees_with_jnp(expr):
    d = (np.arange(120, dtype=np.float32) + 0.5)[:, None]
    got = glsl_expr.evaluate(expr, _env(glsl_expr, torch.as_tensor(d)))
    want = jexpr.evaluate(expr, _env(jexpr, jnp.asarray(d)))
    for a, b in zip(_flat(got), _flat(want), strict=True):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a.astype(np.float64),
                                   np.asarray(b, np.float64), atol=1e-6,
                                   rtol=1e-6)


MIXED = [
    "smoothstep(q, 60.0, d) + clamp(d, q, 50.0)",
    "(q > 1.0 && d > 3.0 ? 1.0 : 0.0) + (q < 2.0 || d < 9.0 ? 0.5 : 0.0)",
    "float(vec2(q, d) == vec2(d, q)) + float(q == d) + mod(q, d + 1.0)",
    "max(q, d) * step(q, d) + mix(q, d, 0.25) + float(int(q) | int(d))",
]


@pytest.mark.parametrize("expr", MIXED)
def test_numpy_and_tensor_operands_mix(expr):
    """A numpy plane ``q`` meets a tensor plane ``d``: the result is a
    tensor on d's device and agrees with the all-numpy result (1e-6)."""
    q = np.linspace(0.5, 7.5, 16, dtype=np.float32)[:, None]
    d = (np.arange(16, dtype=np.float32) * 4.0)[None, :]
    got = glsl_expr.evaluate(expr, glsl_expr.Env(
        variables={"q": q, "d": torch.as_tensor(d)}))
    want = glsl_expr.evaluate(expr, glsl_expr.Env(variables={"q": q, "d": d}))
    assert isinstance(got, torch.Tensor) and got.shape == (16, 16)
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               np.asarray(want, np.float64), atol=1e-6)


def test_pipe_bind_default_and_scalar_knobs():
    env = glsl_expr.Env(defines={"A": "@level:(2.0 * 3.0)"})
    assert glsl_expr.evaluate("A + 1.0", env) == 7.0
    env.pipe_values["level"] = 0.5
    assert glsl_expr.evaluate("A + 1.0", env) == 1.5
    assert glsl_expr.evaluate("#ff000080") == jexpr.evaluate("#ff000080")

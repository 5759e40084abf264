"""The port's device mesh and sharded fleet against the JAX package's.

``make_mesh`` against ``glava_tpu.parallel.mesh.make_mesh`` on the 8 CPU
devices tests/conftest.py gives JAX: the same shapes, axis names, and
error types and messages. The port's ``ShardedRenderer`` over meshes of
repeated CPU devices against the JAX ``BatchedRenderer.sharded_step`` on
a JAX mesh of as many CPU devices, fed the same numpy inputs; a mixed
fleet, which JAX steps unsharded only, against ``MixedBatchedRenderer.step``
(sharding changes no value). Tolerances (the JAX suite's): frames under
the golden rule (tests/test_golden.py:95), textures within 5e-5.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from glava_tpu.parallel.batch import BatchedRenderer as JaxBatched
from glava_tpu.parallel.batch import MixedBatchedRenderer as JaxMixed
from glava_tpu.parallel.mesh import make_mesh as jax_make_mesh
from glava_tpu.parallel.mesh import stream_sharding
from glava_tpu_torch.parallel import (
    BatchedRenderer, MixedBatchedRenderer, ShardedRenderer, make_mesh,
)
from glava_tpu_torch.parallel import mesh as pmesh
from glava_tpu_torch.runtime.fleet import FleetEngine, StreamSpec
from tests.test_torch_fleet import _assert_frames, _inputs, _loads, _pipe

S = 8

# (device count, make_mesh keywords): the streams, rows and hosts forms,
# and each of JAX's refusals
MESH_CASES = {
    "default": (8, {}),
    "one": (1, {}),
    "rows2": (8, {"rows": 2}),
    "streams4": (8, {"streams": 4}),
    "streams2_rows4": (8, {"streams": 2, "rows": 4}),
    "hosts2": (8, {"hosts": 2}),
    "hosts2_rows2": (8, {"hosts": 2, "rows": 2}),
    "hosts4_streams2": (8, {"hosts": 4, "streams": 2}),
    "bad_rows3": (8, {"rows": 3}),
    "bad_rows0": (8, {"rows": 0}),
    "bad_rows_over": (2, {"rows": 4}),
    "bad_streams3": (8, {"streams": 3}),
    "bad_streams0": (8, {"streams": 0}),
    "bad_product": (8, {"streams": 2, "rows": 2}),
    "bad_hosts3": (8, {"hosts": 3}),
    "bad_hosts0": (8, {"hosts": 0}),
    "bad_hosts_rows": (8, {"hosts": 2, "rows": 3}),
    "bad_hosts_product": (8, {"hosts": 2, "streams": 3}),
}


def _outcome(fn):
    try:
        m = fn()
    except Exception as e:    # noqa: BLE001 - the type is what is compared
        return type(e), str(e)
    return m.devices.shape, tuple(m.axis_names)


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_make_mesh_matches_jax(case):
    n, kw = MESH_CASES[case]
    assert len(jax.devices()) >= n
    want = _outcome(lambda: jax_make_mesh(jax.devices()[:n], **kw))
    got = _outcome(lambda: make_mesh(["cpu"] * n, **kw))
    assert got == want
    assert (case.startswith("bad")) == isinstance(want[0], type)


def test_mesh_devices_and_stream_shards():
    """The devices are torch.devices shaped by the axes, repeats allowed;
    the stream shards flatten hosts with streams, in mesh order, each a
    contiguous equal block, as P(stream_axes) splits the leading axis."""
    m = make_mesh(["cpu", "cpu", "cpu", "cpu"], hosts=2)
    assert m.shape == {"hosts": 2, "streams": 2, "rows": 1}
    assert all(d == torch.device("cpu") for d in m.devices.reshape(-1))
    assert pmesh.stream_axes(m) == ("hosts", "streams")
    assert pmesh.stream_shards(m) == [torch.device("cpu")] * 4
    assert pmesh.stream_slices(m, 8) == [slice(0, 2), slice(2, 4),
                                         slice(4, 6), slice(6, 8)]
    # the JAX sharding of the leading axis gives each device the same block
    jm = jax_make_mesh(jax.devices()[:4], hosts=2)
    placed = jax.device_put(jnp.arange(8), stream_sharding(jm))
    blocks = sorted(tuple(np.asarray(sh.data)) for sh in placed.addressable_shards)
    assert blocks == [tuple(range(s.start, s.stop))
                      for s in pmesh.stream_slices(m, 8)]
    with pytest.raises(ValueError, match="do not split evenly"):
        pmesh.stream_slices(m, 6)


def _jax_sharded(jbr, devices, **kw):
    mesh = jax_make_mesh(jax.devices()[:devices], **kw)
    step = jbr.sharded_step(mesh)
    return step, jbr.shard_state(jbr.init_state(), mesh), stream_sharding(mesh)


@pytest.mark.parametrize("form", ["streams2", "streams4", "hosts2"])
def test_sharded_step_matches_jax_sharded_step(form, tmp_path):
    """A bars fleet of S 8 with per-stream fg rows and staggered clocks,
    over 2 or 4 repeated CPU devices (and a hosts mesh of 2 x 2), against
    the JAX sharded step on as many CPU devices: frames under the golden
    rule and textures within 5e-5 every step; every shard renders its
    own block."""
    devices, kw = {"streams2": (2, {}), "streams4": (4, {}),
                   "hosts2": (4, {"hosts": 2})}[form]
    lc, jlc = _loads("bars", tmp_path)
    sr = ShardedRenderer([lc], [0] * S, make_mesh(["cpu"] * devices, **kw))
    assert len(sr.shards) == devices
    assert all(sh.n_streams == S // devices for sh in sr.shards)
    jbr = JaxBatched(jlc, n_streams=S)
    step, js, sharding = _jax_sharded(jbr, devices, **kw)
    pipe = {"fg": _pipe(np.random.default_rng(3), S)["fg"]}
    jpipe = {"fg": jnp.asarray(pipe["fg"])}
    ps = sr.init_state()
    rng = np.random.default_rng(21)
    for it in range(5):
        inputs = _inputs(rng, it, S)
        ps, got = sr.step(ps, *inputs, pipe)
        js, want = step(js, *(jax.device_put(jnp.asarray(a), sharding)
                              for a in inputs), jpipe)
        assert [f.shape[0] for f in got] == [S // devices] * devices
        _assert_frames(torch.cat(got), np.asarray(want), f"{form} step {it}")
    pp = jbr.renderer.pipeline
    want = pp.textures_from(js.chains, js.key_end[:, 0], js.key_end[:, 1])
    for sl, sh, st in zip(sr.slices, sr.shards, ps):
        got = sh.renderer.pipeline.textures_from(
            st.chains, st.key_end[:, 0], st.key_end[:, 1])
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k].numpy(),
                                       np.asarray(want[k])[sl], atol=5e-5)


def test_sharded_step_equals_the_unsharded_fleet(tmp_path):
    """Sharding changes no value: the shards' frames, put together, and
    their states equal one BatchedRenderer's over the same inputs."""
    lc, _ = _loads("radial", tmp_path)
    sr = ShardedRenderer([lc], [0] * S, make_mesh(["cpu"] * 4))
    br = BatchedRenderer(lc, S, device="cpu")
    ps, bs = sr.init_state(), br.init_state()
    rng = np.random.default_rng(22)
    pipe = _pipe(np.random.default_rng(4), S)
    for it in range(4):
        inputs = _inputs(rng, it, S)
        ps, got = sr.step(ps, *inputs, pipe, quantize=True)
        bs, want = br.step(bs, *inputs, pipe, quantize=True)
        assert torch.equal(torch.cat(got), want)
    for name in ("gravity", "history", "avg", "count"):
        assert torch.equal(torch.cat([getattr(p.chains, name) for p in ps]),
                           getattr(bs.chains, name))


def test_mixed_sharded_fleet_matches_jax_mixed_step(tmp_path):
    """bars, radial and wave over 2 shards of a CPU mesh, each shard
    building only the variants its block of ``assign`` uses, against
    the JAX mixed fleet's (unsharded) step: frames under the golden rule
    every step."""
    mods = ["bars", "radial", "wave"]
    loads = [_loads(m, tmp_path) for m in mods]
    assign = [0, 1, 0, 1, 2, 2, 1, 2]
    sr = ShardedRenderer([p for p, _ in loads], assign,
                         make_mesh(["cpu"] * 2))
    assert all(isinstance(sh, MixedBatchedRenderer) for sh in sr.shards)
    assert [len(sh.renderers) for sh in sr.shards] == [2, 2]
    assert [sh.renderers[0].loaded.module for sh in sr.shards] == ["bars",
                                                                   "radial"]
    jmx = JaxMixed([j for _, j in loads], assign)
    jstep = jax.jit(functools.partial(jmx.step, quantize=True))
    pipe = _pipe(np.random.default_rng(9), S)
    jpipe = {k: jnp.asarray(v) for k, v in pipe.items()}
    ps, js = sr.init_state(), jmx.init_state()
    rng = np.random.default_rng(23)
    for it in range(5):
        inputs = _inputs(rng, it, S)
        ps, got = sr.step(ps, *inputs, pipe, quantize=True)
        js, want = jstep(js, *(jnp.asarray(a) for a in inputs), jpipe)
        _assert_frames(torch.cat(got), np.asarray(want), f"mixed step {it}")
    f = torch.cat(got).numpy()
    assert all((f[s][..., 3] > 0).any() for s in range(S))


@pytest.mark.parametrize("kind", ["bars", "mixed"])
def test_fleet_engine_on_a_mesh_renders_every_stream(kind, tmp_path):
    """FleetEngine(mesh=...) on repeated CPU devices runs a few frames
    through one pinned-layout host buffer and hands each stream its own
    frame (a loop check: the audio clock makes the values
    nondeterministic)."""
    lc, _ = _loads("bars", tmp_path)
    wave = _loads("wave", tmp_path)[0] if kind == "mixed" else None
    streams = [StreamSpec(f"s{i}", source=f"synth:{300 + 150 * i},900",
                          pipe={"fg": (1.0, 0.2 * (i % 4), 0.0, 1.0)},
                          loaded=wave if i % 2 else None)
               for i in range(4)]
    eng = FleetEngine(lc, streams, device="cpu",
                      mesh=make_mesh(["cpu"] * 2))
    assert isinstance(eng.br, ShardedRenderer) and len(eng.state) == 2
    eng.set_pipe(0, "fg", (0.0, 1.0, 0.0, 1.0))
    eng.run(max_frames=4)
    assert eng.frames_rendered == 4
    frames = [eng.tex(i) for i in range(4)]
    assert all(f is not None and f.shape == (64, 96, 4) for f in frames)
    assert all((f[..., 3] > 0).any() for f in frames)
    green = frames[0][frames[0][..., 3] > 0]
    assert green[:, :3].mean(axis=0).argmax() == 1     # the live update
    host = eng.fetch(eng.step(np.zeros((4, 2, 1024), np.float32),
                              np.ones(4, bool), 0.0, np.ones(4, np.float32),
                              np.full(4, 0.05, np.float32)))
    assert host.shape == (4, 64, 96, 4) and host.dtype == np.uint8


def test_rows_axis_is_not_taken_by_a_fleet(tmp_path):
    """A mesh whose rows extent is above 1 is made as JAX makes it, but
    a fleet on it raises NotImplementedError naming the ROADMAP item."""
    lc, _ = _loads("bars", tmp_path)
    mesh = make_mesh(["cpu"] * 4, rows=2)
    assert mesh.shape == {"streams": 2, "rows": 2}
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 1"):
        ShardedRenderer([lc], [0] * 4, mesh)
    with pytest.raises(NotImplementedError, match="rows=2"):
        FleetEngine(lc, [StreamSpec(f"s{i}") for i in range(4)],
                    mesh=make_mesh(["cpu"] * 4, hosts=2, rows=2))


def test_default_mesh_needs_a_card(monkeypatch):
    """By default the mesh takes every visible card, cuda:0 .. N-1; with
    none visible it raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = make_mesh(streams=2)
    assert list(m.devices.reshape(-1)) == [torch.device("cuda:0"),
                                           torch.device("cuda:1")]

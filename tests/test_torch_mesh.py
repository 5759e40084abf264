"""The port's device mesh and sharded fleet against the JAX package's.

``make_mesh`` against ``glava_tpu.parallel.mesh.make_mesh`` on the 8 CPU
devices tests/conftest.py gives JAX: the same shapes, axis names, and
error types and messages. The port's ``ShardedRenderer`` over meshes of
repeated CPU devices against the JAX ``BatchedRenderer.sharded_step`` on
a JAX mesh of as many CPU devices, fed the same numpy inputs, on the
streams axis and the rows axis (each device a band of rows: the same
per-device frame shapes as JAX's shards); a mixed fleet, which JAX
steps unsharded only, against ``MixedBatchedRenderer.step`` (sharding
changes no value). Tolerances (the JAX suite's): frames under the golden
rule (tests/test_golden.py:95), textures within 5e-5. Against the port's
own unsharded fleet a rows mesh is byte-equal, module by module.
"""

from __future__ import annotations

import functools
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from glava_tpu.parallel.batch import BatchedRenderer as JaxBatched
from glava_tpu.parallel.batch import MixedBatchedRenderer as JaxMixed
from glava_tpu.parallel.mesh import make_mesh as jax_make_mesh
from glava_tpu.parallel.mesh import stream_sharding
from glava_tpu_torch import renderer as prenderer
from glava_tpu_torch.config import loader
from glava_tpu_torch.parallel import (
    BatchedRenderer, MixedBatchedRenderer, ShardedRenderer, make_mesh,
)
from glava_tpu_torch.parallel import mesh as pmesh
from glava_tpu_torch.runtime.fleet import FleetEngine, StreamSpec
from tests.test_torch_fleet import (
    REQS, _assert_frames, _inputs, _loads, _pipe,
)

S = 8
S4 = 4
ROOT = Path(__file__).resolve().parent.parent

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
    contiguous equal block, as P(stream_axes) splits the leading axis;
    the rows axis splits H into equal contiguous bands."""
    m = make_mesh(["cpu", "cpu", "cpu", "cpu"], hosts=2)
    assert m.shape == {"hosts": 2, "streams": 2, "rows": 1}
    assert all(d == torch.device("cpu") for d in m.devices.reshape(-1))
    assert pmesh.stream_axes(m) == ("hosts", "streams")
    assert pmesh.shard_grid(m).shape == (4, 1)
    assert list(pmesh.shard_grid(m).reshape(-1)) == [torch.device("cpu")] * 4
    assert pmesh.row_bands(m, 64) == [(0, 64)]
    r = make_mesh([f"cpu:{i}" for i in range(8)], hosts=2, rows=2)
    assert [[d.index for d in row] for row in pmesh.shard_grid(r)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    assert pmesh.row_bands(r, 64) == [(0, 32), (32, 64)]
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


def _assemble(sr, frames) -> torch.Tensor:
    """The per-device frames put at their streams and rows of one
    (S, H, W, 4) tensor; every element is written exactly once."""
    w, h = sr.screen
    out = torch.zeros((sr.n_streams, h, w, 4), dtype=frames[0].dtype)
    seen = torch.zeros((sr.n_streams, h), dtype=torch.int64)
    for f, (sl, (r0, r1)) in zip(frames, sr.blocks):
        assert f.shape == (sl.stop - sl.start, r1 - r0, w, 4)
        out[sl, r0:r1] = f
        seen[sl, r0:r1] += 1
    assert bool((seen == 1).all())
    return out


# (devices, make_mesh keywords) of the sharded forms held to JAX
SHARDED_FORMS = {"streams2": (2, {}), "streams4": (4, {}),
                 "hosts2": (4, {"hosts": 2}), "rows2": (2, {"rows": 2}),
                 "streams2_rows2": (4, {"streams": 2, "rows": 2}),
                 "hosts2_rows2": (8, {"hosts": 2, "rows": 2})}


@pytest.mark.parametrize("form", list(SHARDED_FORMS))
def test_sharded_step_matches_jax_sharded_step(form, tmp_path):
    """A bars fleet of S 8 with per-stream fg rows and staggered clocks,
    over 2, 4 or 8 repeated CPU devices (streams, hosts and rows
    meshes), against the JAX sharded step on as many CPU devices: each
    device's frames have the shape and the (streams, rows) block of the
    JAX output's shard on the same mesh position, the frames meet the
    golden rule and the textures 5e-5 every step."""
    devices, kw = SHARDED_FORMS[form]
    lc, jlc = _loads("bars", tmp_path)
    mesh = make_mesh(["cpu"] * devices, **kw)
    rows = mesh.shape["rows"]
    sr = ShardedRenderer([lc], [0] * S, mesh)
    assert len(sr.shards) == devices
    assert all(sh.n_streams == S * rows // devices for sh in sr.shards)
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
        # the JAX shard on mesh position k holds block k of the port
        jshards = sorted(want.addressable_shards,
                         key=lambda sh: sh.device.id)
        h = want.shape[1]
        assert [(*sh.index[0].indices(S)[:2], *sh.index[1].indices(h)[:2],
                 sh.data.shape) for sh in jshards] == [
            (sl.start, sl.stop, r0, r1, tuple(f.shape))
            for f, (sl, (r0, r1)) in zip(got, sr.blocks)]
        _assert_frames(_assemble(sr, got), np.asarray(want),
                       f"{form} step {it}")
    pp = jbr.renderer.pipeline
    want = pp.textures_from(js.chains, js.key_end[:, 0], js.key_end[:, 1])
    for (sl, _), sh, st in zip(sr.blocks, sr.shards, ps):
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
    """A fleet on a mesh whose rows extent is above 1 runs: each device
    renders its stream block's band, and ``FleetEngine.fetch`` copies
    every band into its streams and rows of one (S, H, W, 4) uint8 host
    buffer, byte-equal to the unsharded fleet's frames on the same
    inputs (a streams x rows mesh, and a hosts mesh with rows)."""
    lc, _ = _loads("bars", tmp_path)
    streams = [StreamSpec(f"s{i}", source=f"synth:{300 + 150 * i},900",
                          pipe={"fg": (1.0, 0.2 * i, 0.0, 1.0)})
               for i in range(4)]
    plain = FleetEngine(lc, streams, device="cpu")
    rng = np.random.default_rng(41)
    for mesh in (make_mesh(["cpu"] * 4, rows=2),
                 make_mesh(["cpu"] * 8, hosts=2, rows=2)):
        eng = FleetEngine(lc, streams, mesh=mesh)
        assert isinstance(eng.br, ShardedRenderer)
        assert eng.br.bands == [(0, 32), (32, 64)]
        assert len(eng.state) == mesh.devices.size
        plain.state = plain.br.init_state()
        for it in range(3):
            audio, mods, _, interp, g = _inputs(rng, it, 4)
            parts = eng.step(audio, mods, 0.5, interp, g)
            assert [tuple(f.shape) for f in parts] == [
                (4 // (mesh.devices.size // 2), 32, 96, 4)] * mesh.devices.size
            host = eng.fetch(parts)
            want = plain.fetch(plain.step(audio, mods, 0.5, interp, g))
            assert host.shape == (4, 64, 96, 4) and host.dtype == np.uint8
            assert host.tobytes() == want.tobytes()
        assert (host[..., 3] > 0).any()
        with pytest.raises(ValueError, match="do not fill"):
            eng.fetch([f[:, 1:] for f in parts])
    eng.run(max_frames=3)
    assert eng.frames_rendered == 3
    assert all(eng.tex(i).shape == (64, 96, 4) for i in range(4))


def _shader_load(tmp_path, name="rings"):
    """A load of the docs/examples ``rings`` shader module in the fleet
    configuration."""
    d = tmp_path / "shaders"
    d.mkdir(exist_ok=True)
    if not (d / name).exists():
        shutil.copytree(ROOT / "docs" / "examples" / name, d / name)
    return loader.load(cli_requests=REQS, force_module=name, user_dir=d)


# (module, knob lines) the rows meshes are held to the unsharded fleet
# on: every native module; wave's and graph's outline passes read the
# rows beside the band (one row of halo), graph's anti-alias pass reads
# each column's top wherever it lies; bars under MIRROR_YX slices its
# columns; circle's smoothing reads a row of halo, off without C_SMOOTH
ROWS_CASES = {
    "bars": ("bars", ""), "bars-mirror_yx": ("bars", "#define MIRROR_YX 1\n"),
    "radial": ("radial", ""), "circle": ("circle", ""),
    "circle-no_smooth": ("circle", "#define C_SMOOTH 0\n"),
    "wave": ("wave", ""), "graph": ("graph", ""),
    "graph-no_outline": ("graph", "#define DRAW_HIGHLIGHT 0\n"),
    "graph-anti_alias": ("graph", "#define ANTI_ALIAS 1\n"
                                  "#define DRAW_OUTLINE 1\n"),
    "graph-anti_alias_invert": ("graph", "#define ANTI_ALIAS 1\n"
                                         "#define INVERT 1\n"),
    "graph-anti_alias_no_outline": ("graph", "#define ANTI_ALIAS 1\n"
                                             "#define DRAW_HIGHLIGHT 0\n"),
    "test": ("test", ""), "rings": ("rings", ""),
}


@pytest.mark.parametrize("rows", [2, 4])
@pytest.mark.parametrize("case", list(ROWS_CASES))
def test_rows_mesh_equals_the_unsharded_fleet(case, rows, tmp_path):
    """Four streams over a mesh of 2 stream shards x ``rows`` bands of
    repeated CPU devices, each device a (2, 64 / rows, 96, 4) band,
    byte-equal to one BatchedRenderer's frames every step, with pipe
    rows and staggered clocks; each row group's state replicas equal
    (torch.equal) and equal to the unsharded state's block. A native
    module renders its band only; a shader module (rings) renders the
    whole frame on each device and keeps its band, counted."""
    module, knobs = ROWS_CASES[case]
    lc = (_shader_load(tmp_path) if module == "rings"
          else _loads(module, tmp_path, knobs=knobs)[0])
    sr = ShardedRenderer([lc], [0] * S4, make_mesh(["cpu"] * (2 * rows),
                                                   streams=2, rows=rows))
    br = BatchedRenderer(lc, S4, device="cpu")
    assert all(sh.renderer.module.banded == (module != "rings")
               for sh in sr.shards)
    ps, bs = sr.init_state(), br.init_state()
    rng = np.random.default_rng(23)
    pipe = _pipe(np.random.default_rng(4), S4)
    cut = prenderer.whole_frame_bands
    for it in range(3):
        inputs = _inputs(rng, it, S4)
        ps, got = sr.step(ps, *inputs, pipe, quantize=True)
        bs, want = br.step(bs, *inputs, pipe, quantize=True)
        assert {tuple(f.shape) for f in got} == {(2, 64 // rows, 96, 4)}
        assert torch.equal(_assemble(sr, got), want), f"{case} step {it}"
    assert prenderer.whole_frame_bands - cut == (
        3 * 2 * rows * 2 if module == "rings" else 0)
    if module != "test":
        assert (want[..., 3] > 0).any()
    U = bs.chains.count.shape[0] // S4     # fused rows s * U + u
    for (sl, _), st in zip(sr.blocks, ps):
        block = slice(sl.start * U, sl.stop * U)
        for name in ("gravity", "history", "avg", "count"):
            assert torch.equal(getattr(st.chains, name),
                               getattr(bs.chains, name)[block]), name
        assert torch.equal(st.key_end, bs.key_end[sl])


def test_mixed_rows_fleet_matches_jax_mixed_step(tmp_path):
    """bars, radial and wave over a 2 x 2 streams x rows mesh, each
    device building only the variants its block uses for its band,
    against the JAX mixed fleet's (unsharded) step: frames under the
    golden rule every step, and byte-equal to the port's unsharded
    mixed fleet."""
    mods = ["bars", "radial", "wave"]
    loads = [_loads(m, tmp_path) for m in mods]
    assign = [0, 1, 0, 1, 2, 2, 1, 2]
    sr = ShardedRenderer([p for p, _ in loads], assign,
                         make_mesh(["cpu"] * 4, rows=2))
    assert [len(sh.renderers) for sh in sr.shards] == [2, 2, 2, 2]
    assert [sh.renderers[0].rows for sh in sr.shards] == [
        (0, 32), (32, 64)] * 2
    mx = MixedBatchedRenderer([p for p, _ in loads], assign, device="cpu")
    jmx = JaxMixed([j for _, j in loads], assign)
    jstep = jax.jit(functools.partial(jmx.step, quantize=True))
    pipe = _pipe(np.random.default_rng(9), S)
    jpipe = {k: jnp.asarray(v) for k, v in pipe.items()}
    ps, ms, js = sr.init_state(), mx.init_state(), jmx.init_state()
    rng = np.random.default_rng(24)
    for it in range(4):
        inputs = _inputs(rng, it, S)
        ps, got = sr.step(ps, *inputs, pipe, quantize=True)
        ms, plain = mx.step(ms, *inputs, pipe, quantize=True)
        js, want = jstep(js, *(jnp.asarray(a) for a in inputs), jpipe)
        frames = _assemble(sr, got)
        assert torch.equal(frames, plain)
        _assert_frames(frames, np.asarray(want), f"mixed rows step {it}")
    assert all((frames[s][..., 3] > 0).any() for s in range(S))


def test_rows_that_do_not_divide_h_raise(tmp_path):
    """A frame height the mesh's rows do not divide is refused with
    ValueError, as the JAX sharded step refuses it (H 30 on rows 4)."""
    extra = ("setgeometry 0 0 48 30",)
    lc, jlc = _loads("bars", tmp_path, extra=extra)
    with pytest.raises(ValueError, match="height 30 .* rows=4"):
        ShardedRenderer([lc], [0] * 2, make_mesh(["cpu"] * 8, rows=4))
    with pytest.raises(ValueError, match="height 30 .* rows=4"):
        FleetEngine(lc, [StreamSpec("s0"), StreamSpec("s1")],
                    mesh=make_mesh(["cpu"] * 4, rows=4))
    with pytest.raises(ValueError, match="height 30 .* rows=4"):
        pmesh.row_bands(make_mesh(["cpu"] * 4, rows=4), 30)
    jbr = JaxBatched(jlc, n_streams=2)
    step, js, sharding = _jax_sharded(jbr, 8, rows=4)
    inputs = _inputs(np.random.default_rng(1), 0, 2)
    with pytest.raises(ValueError, match="divisible by 4"):
        step(js, *(jax.device_put(jnp.asarray(a), sharding)
                   for a in inputs), {})


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

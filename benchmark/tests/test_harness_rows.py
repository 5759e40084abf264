"""The check by the program's own rows: every fft uniform row of every
stream, each replayed from the PCM channel its uniform names, whatever
the module declares (two rows, one row, in any order). The program's
update is driven here directly on the CPU from seeded PCM, a frame's
raster is a stub that draws the textures it is given by name, and the
record is judged as a run's would be; then a whole run of the port's
example shader module ``rings`` through the engine driver."""

from __future__ import annotations

import copy
import sys
import types

import numpy as np
import pytest
import torch

import helpers
from benchlib import check, pcm as pcm_mod, runner, system

CHAIN = ("window", "fft", "gravity", "avg")
SEEN: list = []          # the texture names each stub draw was given


class StubRaster:
    """Draws channel ``c`` of column ``x`` as texture ``c`` (its names in
    order) at texel ``x * sz // w``, the same on every row."""

    def __init__(self, knobs: dict, w: int, h: int, sz: int, device):
        self.h = h
        self.cols = torch.arange(w, device=device) * sz // w

    def render(self, tex: dict, feed: torch.Tensor, pipe: dict | None):
        SEEN.append(tuple(sorted(tex)))
        S, w = feed.shape[0], len(self.cols)
        out = torch.zeros((S, self.h, w, 4), dtype=torch.uint8,
                          device=feed.device)
        for c, name in enumerate(sorted(tex)):
            v = torch.clamp(tex[name][:, self.cols], 0.0, 1.0)
            out[..., c] = torch.round(v * 255.0).to(torch.uint8)[:, None, :]
        return out


@pytest.fixture
def stub(monkeypatch):
    import reference

    SEEN.clear()
    mod = types.SimpleNamespace(Module=StubRaster)
    monkeypatch.setattr(reference, "module", lambda name: mod)
    return SEEN


def _config() -> dict:
    _, config, _ = runner.cell_files("rc_bars.live")
    config = copy.deepcopy(config)
    config["geometry"] = [96, 64]
    return config


def _load(module: str):
    from glava_tpu_torch.config import loader

    user_dir = helpers.ROOT / "docs" / "examples" if module == "rings" else None
    return loader.load(entry="rc.glsl", user_dir=user_dir,
                       cli_requests=("setgeometry 0 0 96 64",),
                       force_module=module)


def _pipeline(module=None, declared=None):
    """(pipeline, the uniforms its module binds) of a shipped or example
    module, or of uniforms ``declared`` as (name, source) pairs."""
    from glava_tpu_torch.pipeline import AudioPipeline, UniformSpec
    from glava_tpu_torch.renderer import Renderer

    if module is not None:
        r = Renderer(_load(module), device="cpu")
        return r.pipeline, r.uniforms
    specs = [UniformSpec(name, src, CHAIN) for name, src in declared]
    return AudioPipeline(_load("bars").cfg, specs, device="cpu"), specs


def _drive(pipeline, uniforms, S=3, K=10, fault=None, seed=helpers.SEED):
    """A run's record of ``K`` frames of ``S`` streams updated by the
    program from seeded PCM (stream ``s`` fresh on about 2 frames in 3,
    every stream on the first), the last frame of each stream sampled
    and drawn by the stub from the program's own textures."""
    from glava_tpu_torch.pipeline import clone_state

    config = _config()
    dsp = config["dsp"]
    n, hop = int(dsp["bufsize"]), int(dsp["samplesize"]) // 4
    rng = np.random.default_rng(seed)
    mods = rng.random((K, S)) < 0.67
    mods[0] = True
    pushes = 8 + np.cumsum(mods * rng.integers(1, 3, (K, S)), axis=0)
    pcm = pcm_mod.make_pcm(seed, S, int(pushes.max()) * hop + n,
                           int(dsp["sample_rate"]))
    times = 100.0 + 0.004 * np.stack([np.arange(K), np.arange(K) + 0.5], 1)
    runs, ticks, ups = [(0, 99.999)], np.zeros(K, bool), np.zeros((K, S))
    from reference import gravity

    g, _ = gravity.steps(runs, times, ticks, mods, ups, dsp)
    state = pipeline.init_state(batch=(S,))
    key = np.zeros(S, np.int64)
    for k in range(K):
        key[mods[k]] = pushes[k, mods[k]]
        win = check._windows(torch.as_tensor(pcm), np.arange(S), key, hop, n)
        if fault == "other_channel":
            win[1] = win[1].flip(0)
        old = clone_state(state)
        new = pipeline.advance(state, win[:, 0], win[:, 1], gravity_g=g[k])
        if fault == "dropped":
            for t, o in zip(new, old):
                t[1] = o[1]
        state = pipeline.select_updated(new, old, torch.as_tensor(mods[k]))
    if fault == "swapped":
        for t in state[:3]:
            t[[0, 1]] = t[[1, 0]]
    names = system.bound_names(pipeline, uniforms)
    got = system.program_rows([(state, pipeline, [names] * S)])
    feed = check._windows(torch.as_tensor(pcm), np.arange(S), key, hop, n)
    tex = pipeline.textures_from(state, feed[:, 0], feed[:, 1])
    frames = StubRaster({}, 96, 64, n, "cpu").render(
        {m: tex[p] for m, p in names.items()}, feed, None)
    SEEN.clear()
    rec = check.RunRecord(
        ["stub"] * S, {}, pushes, mods, g, times, ticks, ups, runs,
        [(s, K - 1, frames[s].numpy()) for s in range(S)], got, {})
    config["knobs"] = {"stub": {}}
    return rec, pcm, config


def _judge(rec, pcm, config, control=False):
    return check.judge(rec, pcm, config, "cpu", control=control)


@pytest.mark.parametrize("declared", [
    (("audio_l", "audio_l"), ("audio_r", "audio_r")),
    (("audio_r", "audio_r"), ("audio_l", "audio_l")),
], ids=["l-r", "r-l"])
def test_every_row_is_replayed_from_its_own_channel(declared, stub):
    pipeline, uniforms = _pipeline(declared=declared)
    rec, pcm, config = _drive(pipeline, uniforms)
    S = rec.pushes.shape[1]
    assert [(r.stream, r.uniform, r.source) for r in rec.state["rows"]] == [
        (s, name, src) for s in range(S) for name, src in declared]
    assert rec.state["binds"] == [
        {name: 2 * s + i for i, (name, _) in enumerate(declared)}
        for s in range(S)]
    r = _judge(rec, pcm, config)["program"]
    assert check.verdict(r), r
    assert r["spec_err"] > 0
    assert stub == [("audio_l", "audio_r")] * 3 * S


def test_two_channels_keep_the_order_and_layout_of_two_rows_a_stream():
    """(audio_l, audio_r): row ``2 s + c`` is stream ``s``'s channel
    ``c``, the program's own rows unmoved."""
    pipeline, uniforms = _pipeline("bars")
    state = pipeline.init_state(batch=(4,))
    for t in state[:3]:
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(3)))
    got = system.program_rows([(state, pipeline,
                                [system.bound_names(pipeline, uniforms)] * 4)])
    assert [(r.stream, r.source) for r in got["rows"]] == [
        (s, c) for s in range(4) for c in ("audio_l", "audio_r")]
    for name in ("gravity", "avg"):
        assert np.array_equal(got[name], getattr(state, name).numpy())
    assert check.replayed_rows(got["rows"])[1].tolist() == [0, 1] * 4


def test_rings_holds_one_row_a_stream_and_passes(stub):
    pipeline, uniforms = _pipeline("rings")
    rec, pcm, config = _drive(pipeline, uniforms, S=2)
    assert [(r.stream, r.uniform, r.source) for r in rec.state["rows"]] == [
        (0, "audio_l", "audio_l"), (1, "audio_l", "audio_l")]
    assert rec.state["gravity"].shape[0] == 2
    r = _judge(rec, pcm, config, control=True)
    assert check.verdict(r["program"]), r["program"]
    assert r["control"]["spec_err"] > check.LIMITS["spec_err"], r["control"]
    assert set(stub) == {("audio_l",)}


def test_a_fleet_union_pipeline_binds_each_modules_own_names():
    """A wave stream in a mixed fleet holds the union's rows and binds
    none of them; the others bind their names to the union's."""
    from glava_tpu_torch.parallel.batch import MixedBatchedRenderer

    br = MixedBatchedRenderer([_load(m) for m in ("bars", "wave", "rings")],
                              [0, 1, 2, 0], device="cpu")
    state = br.init_state().chains
    binds = [system.bound_names(br.pipeline, br.renderers[a].uniforms)
             for a in br.assign]
    got = system.program_rows([(state, br.pipeline, binds)])
    U = len(br.pipeline.fft_uniforms)
    assert U == 2 and len(got["rows"]) == 4 * U
    assert got["binds"] == [{"audio_l": 0, "audio_r": 1}, {}, {"audio_l": 4},
                            {"audio_l": 6, "audio_r": 7}]


@pytest.mark.parametrize("fault", ["dropped", "swapped", "other_channel"])
def test_a_row_out_of_place_is_caught(fault, stub):
    pipeline, uniforms = _pipeline("bars")
    rec, pcm, config = _drive(pipeline, uniforms, fault=fault)
    r = _judge(rec, pcm, config)["program"]
    assert r["spec_err"] > check.LIMITS["spec_err"], r
    assert not check.verdict(r)


def test_a_state_with_a_row_less_than_its_map_raises(stub):
    pipeline, uniforms = _pipeline("bars")
    rec, pcm, config = _drive(pipeline, uniforms)
    for name in ("gravity", "avg"):
        rec.state[name] = rec.state[name][1:]
    with pytest.raises(ValueError, match="other rows"):
        _judge(rec, pcm, config)
    state = pipeline.init_state(batch=(3,))
    with pytest.raises(ValueError, match="holds 6 rows"):
        system.program_rows([(state, pipeline, [{}] * 2)])


@pytest.mark.parametrize("source, chain", [
    ("audio_m", CHAIN), ("audio_l", ("window", "fft", "avg")),
    ("audio_r", CHAIN + ("smooth",))])
def test_a_row_the_reference_does_not_replay_raises(source, chain, stub):
    pipeline, uniforms = _pipeline("bars")
    rec, pcm, config = _drive(pipeline, uniforms, S=2)
    rows = list(rec.state["rows"])
    rows[3] = rows[3]._replace(uniform="mine", source=source, chain=chain)
    rec.state["rows"] = rows
    with pytest.raises(ValueError, match="stream 1: uniform 'mine'"):
        _judge(rec, pcm, config)


def rings_cell() -> tuple:
    """(cell, configuration, traffic) of rings through the engine driver
    at 96x64 with rc.glsl's DSP, and no sampled frame: the reference has
    no rings raster."""
    entry, config, traffic, _ = helpers.tiny("rc_bars.live")
    config = copy.deepcopy(config)
    config.update(name="rings", user_dir="docs/examples",
                  force_module="rings", modules=["rings"],
                  knobs={"rings": {}})
    traffic = copy.deepcopy(traffic)
    traffic["check"] = {"streams": 1, "frames": 0}
    return dict(entry, name="rings.live", config="rings"), config, traffic


def test_a_user_shader_module_runs_whole_and_its_control_fails(monkeypatch):
    import time

    raster = types.ModuleType("reference.rings")
    raster.Module = StubRaster
    monkeypatch.setitem(sys.modules, "reference.rings", raster)
    cell, config, traffic = rings_cell()
    e2e = [m for m in runner.manifest()["end_to_end"]
           if "rc_bars.live" in m.get("workloads", ["rc_bars.live"])]
    out = runner.run_cell(cell, config, traffic, helpers.SEED, 2.5, False,
                          ["cpu"], time.perf_counter(), control=True,
                          end_to_end=e2e)
    r = out["readings"]
    assert out["line"]["correct"], r["program"]
    assert out["line"]["attempted"] > 0
    assert r["program"]["unresolved"] == r["program"]["unpaired"] == 0
    assert r["control"]["spec_err"] > check.LIMITS["spec_err"], r["control"]
    assert not check.verdict(r["control"])


@pytest.mark.parametrize("cell, rows", [("rings", [1]), ("rc_bars.live", [2]),
                                        ("fleet_native4.s64", [16])])
def test_the_update_roofline_counts_the_rows_the_program_holds(cell, rows):
    from benchlib import live

    if cell == "rings":
        entry, config, traffic = rings_cell()
    else:
        entry, config, traffic, _ = helpers.tiny(cell)
    S = int(traffic["streams"])
    live.install(pcm_mod.make_pcm(1, S, 4096, 22050))
    system_ = runner.driver(traffic.get("driver", config["driver"])).build(
        config, traffic, live.Recorder(S), ["cpu"], helpers.SEED)
    try:
        assert system_.shapes["rows"] == rows
    finally:
        system_.close()

"""The port's span recorder (``glava_tpu_torch.utils.profiling``) on the
CPU: off unless a profiler session or ``record()`` is open, the tree of
span kinds from a live ``Engine`` and ``FleetEngine`` run, a fleet
run's fetches and ``fetch.wait``'s payload, ``FrameFetch.ready``, the
store's bound and its sessions, and a compiled step's capture after a
new input layout. Also: a fleet's second ``run`` gets fresh audio."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import pytest
import torch

from glava_tpu_torch import compiled
from glava_tpu_torch.config import glsl_shader, loader
from glava_tpu_torch.runtime import sinks
from glava_tpu_torch.runtime.engine import Engine, EngineOptions, FrameFetch
from glava_tpu_torch.runtime.fleet import FleetEngine, StreamSpec
from glava_tpu_torch.utils import profiling
from tests.test_glsl_shader import EQ_FRAG

REQS = ("setgeometry 0 0 48 32", "setprintframes false", "setbufsize 1024",
        "setsamplesize 256")
# each kind's parent, or the kinds one of which is its parent
# (utils/profiling.py's tree)
PARENT = {"snapshot": "frame", "step": "frame", "fetch": "frame",
          "sink": "frame", "fuel": "frame", "step.load": "step",
          "step.stage_wait": "step.load", "step.replay": "step",
          "step.capture": "step", "fetch.copy": "fetch",
          "fetch.wait": "fetch",
          "shader.pass": ("step.replay", "step.capture")}
KINDS = {"frame", *PARENT}


@pytest.fixture
def fresh(monkeypatch):
    """No store and no recording left by an earlier test of the process;
    a shader's fuel counters read on the first frame."""
    monkeypatch.setattr(profiling, "_store", None)
    monkeypatch.setattr(profiling, "_depth", 0)
    monkeypatch.setitem(glsl_shader._FUEL_WARN_STATE, "read", -1e9)


def _shader_dir(tmp_path):
    (tmp_path / "sb").mkdir()
    (tmp_path / "sb" / "1.frag").write_text(EQ_FRAG)
    return str(tmp_path)


def _engine(tmp_path=None, frames=None):
    return Engine(EngineOptions(
        audio_backend="synth", screen=(48, 32), device="cpu",
        requests=("setprintframes false",),
        user_dir=_shader_dir(tmp_path) if tmp_path else None,
        force_module="sb" if tmp_path else None),
        sink=sinks.CallbackSink(lambda f, t: None if frames is None
                                else frames.append(f)))


def _fleet(tmp_path=None, streams=2):
    lc = (loader.load(user_dir=_shader_dir(tmp_path), force_module="sb",
                      cli_requests=REQS) if tmp_path
          else loader.load(cli_requests=REQS))
    return FleetEngine(lc, [StreamSpec(f"s{i}", source=f"synth:{300 + 200 * i},900")
                            for i in range(streams)], device="cpu")


def _assert_tree(spans):
    """Every span of a frame lies in its frame's span and in a span of
    its parent kind of the same frame."""
    by = {}
    for s in spans:
        if s.frame is not None:
            by.setdefault((s.loop, s.frame), {}).setdefault(s.kind, []).append(s)
    assert by
    for key, kinds in by.items():
        if "frame" not in kinds:
            continue
        (fr,) = kinds["frame"]
        for kind, group in kinds.items():
            for s in group:
                assert fr.start <= s.start <= s.end <= fr.end, (key, s)
                if kind != "frame":
                    parents = PARENT[kind]
                    if isinstance(parents, str):
                        parents = (parents,)
                    assert any(p.start <= s.start and s.end <= p.end
                               for k in parents
                               for p in kinds.get(k, ())), (key, s)


def test_recording_is_off_without_a_session(fresh):
    """With no profiler and outside ``record()`` no span is stored and no
    store is made, through an Engine run and a fleet run."""
    assert not profiling.recording() and profiling.begin() == 0.0
    _engine().run(max_frames=4)
    _fleet().run(max_frames=3)
    assert profiling._store is None and profiling.spans() == []


def test_record_and_a_profiler_session_turn_recording_on(fresh):
    """The flag is torch's own; a test that fails here after a torch
    upgrade means it moved."""
    from torch.profiler import ProfilerActivity, profile

    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    with profiling.record():
        assert profiling.recording() and profiling.begin() > 0
    assert not profiling.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        ts = profiling.begin()
        profiling.end("probe", ts)
    assert not profiling.recording() and profiling.begin() == 0.0
    assert [s.kind for s in profiling.spans()] == ["probe"]


def test_each_session_has_a_store_of_its_own(fresh):
    """``record()`` starts a store of its own; the spans of profiler
    sessions opened elsewhere join the store as it is, and a reader picks
    a session's frames by their times."""
    from torch.profiler import ProfilerActivity, profile

    def frames(lo=float("-inf"), hi=float("inf")):
        return {s.frame for s in profiling.spans()
                if s.kind == "frame" and lo <= s.start and s.end <= hi}

    eng = _engine()
    with profiling.record():
        eng.run(max_frames=3)
    assert frames() == {0, 1, 2}
    with profiling.record():
        eng.run(max_frames=5)
    assert frames() == {3, 4}
    eng.run(max_frames=7)
    bounds = []
    for n in (9, 13):
        with profile(activities=[ProfilerActivity.CPU]):
            t0 = time.perf_counter()
            eng.run(max_frames=n)
            bounds.append((t0, time.perf_counter()))
        eng.run(max_frames=n + 2)
    # frames 5-6, 9-10 and 13-14 ran with recording off
    assert frames() == {3, 4, 7, 8, 11, 12}
    assert frames(*bounds[0]) == {7, 8} and frames(*bounds[1]) == {11, 12}


@pytest.mark.parametrize("loop", ["engine", "fleet"])
def test_a_run_records_every_kind_nested(loop, fresh, tmp_path):
    """A shader module (its fuel counters read) through the Engine and
    through a fleet: every kind of the tree, each inside its parent and
    its frame (but ``step.stage_wait``: the CPU stages nothing, so never
    waits for a staging buffer); ``step.load`` counts the bytes staged."""
    with profiling.record():
        if loop == "engine":
            _engine(tmp_path).run(max_frames=4)
        else:
            _fleet(tmp_path).run(max_frames=3)
    spans = profiling.spans()
    assert {s.kind for s in spans} == KINDS - {"step.stage_wait"}
    _assert_tree(spans)
    frames = [s for s in spans if s.kind == "frame"]
    assert len(frames) == (4 if loop == "engine" else 3)
    assert len({s.loop for s in frames}) == 1
    assert all(s.payload > 0 for s in spans if s.kind == "step.load")
    assert profiling.dropped() == 0


def test_a_fleet_run_fetches_each_frame_once(fresh):
    """A fleet run keeps one frame in flight: each frame pushes its copy
    (one ``fetch.copy``), and each frame is waited for once (one
    ``fetch.wait``), in the next frame's check for an ended copy or
    push (on the CPU every copy has ended at the next frame's first
    check), or in the drain after the run's last frame; no ``fetch``
    lies inside another, and each wait's payload is 0 or 1."""
    with profiling.record():
        _fleet().run(max_frames=4)
    spans = profiling.spans()
    _assert_tree(spans)
    for n in range(4):
        kinds = [s.kind for s in spans if s.frame == n]
        assert kinds.count("fetch.copy") == 1
        assert kinds.count("fetch.wait") == (n > 0)
    (drain,) = [s for s in spans if s.frame is None and s.kind == "fetch"]
    (last,) = [s for s in spans if s.frame is None and s.kind == "fetch.wait"]
    assert drain.start <= last.start <= last.end <= drain.end
    fetches = [s for s in spans if s.kind == "fetch"]
    assert not any(a is not b and a.start <= b.start and b.end <= a.end
                   for a in fetches for b in fetches)
    waits = [s.payload for s in spans if s.kind == "fetch.wait"]
    assert len(waits) == 4 and set(waits) <= {0, 1}


class _Event:
    """A copy's event that has or has not completed, counting queries."""

    def __init__(self, done: bool):
        self.done, self.queries, self.waits = done, 0, 0

    def query(self) -> bool:
        self.queries += 1
        return self.done

    def synchronize(self) -> None:
        self.waits += 1


@pytest.mark.parametrize("recording", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("done", [False, True], ids=["running", "done"])
def test_fetch_wait_flags_a_copy_still_running(fresh, recording, done):
    """``fetch.wait``'s payload is 1 when the frame's copy had not ended
    as the wait began, else 0; with recording off no event is queried,
    and the wait is the same either way."""
    ev = _Event(done)
    host = torch.zeros(4, dtype=torch.uint8)
    with profiling.record() if recording else contextlib.nullcontext():
        buf, t = FrameFetch._finish((host, host, ev, 0.5, ("rgba8",)))
    assert t == 0.5 and buf.shape == (4,) and ev.waits == 1
    assert ev.queries == int(recording)
    assert [s.payload for s in profiling.spans()] == ([int(not done)]
                                                      if recording else [])


def test_ready_hands_out_only_ended_copies(fresh):
    """``FrameFetch.ready`` hands out, oldest first and without waiting,
    the pending frames whose copies have ended, up to the first that has
    not; its waits read 0."""
    fetch = FrameFetch("cpu", 2)
    events = [_Event(True), _Event(False), _Event(True)]
    for k, ev in enumerate(events):
        host = torch.full((2,), k, dtype=torch.uint8)
        fetch._pending.append((host, host, ev, float(k), ("rgba8",)))
    with profiling.record():
        first = fetch.ready()
        events[1].done = True
        rest = fetch.ready()
    assert [t for _, t in first] == [0.0] and [t for _, t in rest] == [1.0, 2.0]
    assert [int(buf[0]) for buf, _ in first + rest] == [0, 1, 2]
    assert len(fetch) == 0 and [ev.waits for ev in events] == [1, 1, 1]
    assert [s.payload for s in profiling.spans() if s.kind == "fetch.wait"] == [0, 0, 0]
    assert fetch.ready() == []


def test_the_store_keeps_the_newest_spans(fresh, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 8)
    with profiling.record():
        for i in range(20):
            profiling.end(f"s{i}", profiling.begin(), i)
    assert [s.payload for s in profiling.spans()] == list(range(12, 20))
    assert profiling.dropped() == 12


def test_a_new_input_layout_captures_anew(fresh):
    """A new input layout drops the branch's graph: its next call is a
    capture, and later calls are replays."""
    step = compiled.Step("cpu", {"x": torch.float32})

    def body(branch):
        return step.inputs["x"] * 2

    with profiling.record():
        for n in (3, 3, 4, 4):
            step.load(x=np.ones(n, np.float32))
            step.run(True, body)
    got = [s.kind for s in profiling.spans()
           if s.kind in ("step.capture", "step.replay")]
    assert got == ["step.capture", "step.replay",
                   "step.capture", "step.replay"]
    loads = [s.payload for s in profiling.spans() if s.kind == "step.load"]
    assert loads == [12, 12, 16, 16]


def test_a_second_fleet_run_gets_fresh_audio():
    """``run`` leaves no stream's capture stopped: the snapshots of a
    second run see new hops."""
    fleet = _fleet(streams=1)
    fleet.run(max_seconds=0.5)
    ad = fleet.audio[0]
    mods, snapshot = [], ad.snapshot

    def spy():
        buf, mod = snapshot()
        mods.append(mod)
        return buf, mod

    ad.snapshot = spy
    fleet.run(max_seconds=1.0)
    assert sum(mods) >= 5, (sum(mods), len(mods))

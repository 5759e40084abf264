"""The check that decides ``correct``, driven through a whole run of each
cell (capture threads, the live loop, sinks, the reference) at a size a
CPU test run can hold: sound runs pass, the control fails, and so does
a run whose timed path is broken underneath, once for each fault a cell
can have. On a card, the same at the cells' own size."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import helpers
from benchlib import check, runner

CELLS = ["rc_bars.live", "fleet_native4.s64"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(cell):
    out = helpers.run(cell, control=True)
    r = out["readings"]
    assert out["line"]["correct"], r["program"]
    assert r["program"]["unresolved"] == r["program"]["unpaired"] == 0
    assert r["program"]["gravity_off"] == 0
    assert not check.verdict(r["control"]), r["control"]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_line_carries_the_metrics_its_cell_lists(cell, trace):
    """Untraced, the end-to-end metrics BENCHMARK.json gives the cell and
    no other, less those of the device trace, which a CPU run has not;
    traced, the per-layer ones read on the host (a quantity split by
    cells, ``fetch_ms.fleet``, by its quantity), among them the frame's
    p95 and the stream-frames a second where the cell reads them per
    layer."""
    bench = runner.manifest()
    out = helpers.run(cell, trace=trace)
    got = set(out["line"]["metrics"])
    if not trace:
        assert got == {m["name"] for m in bench["end_to_end"]
                       if cell in m.get("workloads", [cell])
                       and m["source"] != "device_trace"}
        return
    host = {"loop_self_ms", "snapshot_ms", "step_host_ms", "fetch_ms"}
    listed = {m["name"] for m in bench["per_layer"]
              if cell in m.get("workloads", [cell])}
    base = {n.split(".", 1)[0]: n for n in listed}
    want = {base[q] for q in host | ({"handoff_p95_ms", "stream_frames_per_s"}
                                     & set(base))}
    assert want <= got <= listed
    values = out["line"]["metrics"]
    for q in ("handoff_p95_ms", "stream_frames_per_s"):
        if q in base:
            assert 0 < values[base[q]]["value"] < 1e6


def _fault_state_unchanged(mp):
    """The update returns the state it was given."""
    from glava_tpu_torch.pipeline import AudioPipeline

    mp.setattr(AudioPipeline, "advance",
               lambda self, state, *a, **k: state)


def _fault_half_left_out(mp):
    """The second half of the streams never reaches the update."""
    from glava_tpu_torch.runtime.fleet import FleetEngine

    orig = FleetEngine.step

    def step(self, snaps, mods, *a, **k):
        mods = mods.copy()
        mods[len(mods) // 2:] = False
        return orig(self, snaps, mods, *a, **k)

    mp.setattr(FleetEngine, "step", step)


def _fault_answer_altered(mp):
    """Every frame comes out of the step with one row of 8 pixels off."""
    from glava_tpu_torch import renderer
    from glava_tpu_torch.parallel import batch

    def altered(orig):
        def fn(*a, **k):
            out = orig(*a, **k).clone()
            out[..., 0, :8, :] = 255 - out[..., 0, :8, :]
            return out
        return fn

    mp.setattr(renderer, "interleave_u8", altered(renderer.interleave_u8))
    mp.setattr(batch, "interleave_u8", altered(batch.interleave_u8))


def _fault_nominal_rate_doubled(mp):
    """The loop starts its gravity feedback, and guards it, at twice the
    updates a second that the sample rate and hop give."""
    from glava_tpu_torch.config.state import RenderConfig

    mp.setattr(RenderConfig, "nominal_ups",
               property(lambda self: 2.0 * self.sample_rate / self.hop))


def _fault_gravity_times_rate(mp):
    """The fleet's gravity step multiplies by the measured rate."""
    from glava_tpu_torch.runtime.fleet import FleetDynamics

    mp.setattr(FleetDynamics, "gravity", lambda self, step: (
        step * np.maximum(self.ur, 1.0)).astype(np.float32))


FAULTS = [
    ("rc_bars.live", _fault_state_unchanged),
    ("rc_bars.live", _fault_answer_altered),
    ("rc_bars.live", _fault_nominal_rate_doubled),
    ("fleet_native4.s64", _fault_state_unchanged),
    ("fleet_native4.s64", _fault_half_left_out),
    ("fleet_native4.s64", _fault_answer_altered),
    ("fleet_native4.s64", _fault_gravity_times_rate),
]


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c}-{f.__name__[7:]}" for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = helpers.run(cell)
    assert not out["line"]["correct"], out["readings"]["program"]


def test_snapshots_resolve_to_their_hop_counts():
    from benchlib import pcm

    x = pcm.make_pcm(5, 2, 4096, 22050)
    n = np.array([0, 1, 7, 15])
    snaps = check._windows(torch.as_tensor(x), np.full(4, 1), n, 256, 1024)
    fp = snaps[:, :, -1].numpy()
    assert (snaps[0] == 0).all() and (snaps[1, :, :-256] == 0).all()
    # pushes counted before the snapshot (up to 9 behind) and after it
    # (one may not be counted yet)
    got = check.resolve(x, 1, np.maximum(n - 9, 0), np.maximum(n - 1, 0),
                        fp, 256)
    assert (got == n).all()
    assert (check.resolve(x, 1, n, n, fp + 1.0, 256)[1:] == -1).all()


def _loop(seconds=2.5, frame_s=0.004, every=(3, 5), measure=None,
          tick=1.0):
    """A model of the Engine's loop over two streams (a frame every
    ``frame_s``; stream ``i`` has fresh audio every ``every[i]`` frames):
    what the record holds, and the steps it gives. ``measure(count,
    frames, span)`` is its measured rate (updates over seconds), ``tick``
    the seconds between ticks."""
    dsp = {"sample_rate": 22050, "samplesize": 1024, "gravity_step": 4.2}
    nominal = 22050 / 256
    measure = measure or (lambda count, frames, span: count / span)
    K = int(seconds / frame_s)
    times = np.stack([np.arange(K) * frame_s + 0.001,
                      np.arange(K) * frame_s + 0.002], axis=1) + 100.0
    mods = np.stack([np.arange(K) % e == 0 for e in every], axis=1)
    ups, ticks, g = np.zeros((K, 2)), np.zeros(K, bool), np.zeros((K, 2))
    ur, cur = np.full(2, nominal), np.zeros(2)
    count, frames, mark = np.zeros(2), 0, 100.0
    for k in range(K):
        g[k] = dsp["gravity_step"] / np.maximum(ur, 1.0)
        ups[k] = cur
        count += mods[k]
        frames += 1
        now = times[k, 1] + 0.0005          # after the hand-off
        if now - mark >= tick:
            cur = measure(count, frames, now - mark)
            ur = np.maximum(cur, nominal / 8)
            count, frames, mark = np.zeros(2), 0, now
            if k + 1 < K:
                ticks[k + 1] = True
    return [(0, 100.0)], times, ticks, mods, ups, dsp, g.astype(np.float32)


@pytest.mark.parametrize("fault, off", [
    (None, False),
    ({"measure": lambda count, frames, span: frames / span}, True),
    ({"measure": lambda count, frames, span: count / (2 * span)}, True),
    ({"measure": lambda count, frames, span: count * 0.0}, True),
    ({"tick": 2.0}, True),
], ids=["sound", "frames-not-updates", "span-doubled", "zero", "tick-missed"])
def test_gravity_steps_follow_the_measured_rate(fault, off):
    from reference import gravity

    runs, times, ticks, mods, ups, dsp, g_prog = _loop(**(fault or {}))
    g_ref, missed = gravity.steps(runs, times, ticks, mods, ups, dsp)
    wrong = missed + int((np.abs(g_prog - g_ref)
                          > check.GRAVITY_RTOL * g_ref).sum())
    assert (wrong > 0) == off, (missed, wrong)
    if fault is None:
        assert ticks.sum() == 2 and (g_ref[-1] != g_ref[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_is_correct_and_its_control_is_not(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs on the card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(helpers.SEED), "--seconds", "5", "--trace", "0",
         "--control", "1"],
        cwd=helpers.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert not check.verdict(line["control"])


def test_one_feeder_paces_every_stream_in_real_time():
    import threading
    import time

    from glava_tpu_torch.runtime.audio import AudioData

    from benchlib import live, pcm

    live.install(pcm.make_pcm(9, 3, 22050, 22050))
    audios, backs, threads = [], [], []
    for s in range(3):
        ad = AudioData(buffer=np.zeros((2, 1024), np.float32), sample_sz=1024,
                       rate=22050, channels=2, source=f"bench:{s}")
        be = live.PCMBackend()
        be.init(ad)
        audios.append(ad)
        backs.append(be)
    for be, ad in zip(backs, audios):
        threads.append(threading.Thread(target=be.entry, args=(ad,)))
        threads[-1].start()
    time.sleep(1.0)
    for ad in audios:
        ad.terminate = True
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()
    hops = 22050 / 256                       # 86.1 a second
    for be in backs:
        assert abs(be.count - hops) <= 0.1 * hops, be.count
    assert sum(t.name.startswith("Thread") for t in threading.enumerate()
               if t.is_alive()) == 0

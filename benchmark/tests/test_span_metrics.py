"""The readers of the program's own spans (``fetch_wait_ms``,
``copy_wait_ms``, ``step_load_ms``, ``step_replay_ms``): on a hand-built
span list and device trace, each gives its per-frame value over the
stretch's whole frames; with no stretch, no whole frame or no recorder
in the program, nothing. On a card, each cell traced for a few seconds
reports all four, and the spans and the device trace share one clock."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import helpers
from benchlib import runner, spans as spans_mod, trace as trace_mod
from glava_tpu_torch.utils import profiling
from glava_tpu_torch.utils.profiling import Span

METRICS = ["fetch_wait_ms", "copy_wait_ms", "step_load_ms", "step_replay_ms"]
KINDS = {"frame", "snapshot", "step", "step.load", "step.stage_wait",
         "step.replay", "step.capture", "fetch", "fetch.copy", "fetch.wait",
         "sink", "fuel"}
DTOH = "Memcpy DtoH (Device -> Pinned)"


def _frame(k: int, t: float) -> list:
    """Frame ``k`` of loop 0 from ``t`` to ``t + 10``: load 1-3, replay
    3-4, a fetch wait 6-9 (times in seconds, for round numbers)."""
    return [Span("step.load", 0, k, t + 1, t + 3, 64),
            Span("step.replay", 0, k, t + 3, t + 4, 0),
            Span("step", 0, k, t + 1, t + 5, 0),
            Span("fetch.wait", 0, k, t + 6, t + 9, 0),
            Span("fetch", 0, k, t + 5, t + 9, 0),
            Span("frame", 0, k, t, t + 10, 0)]


def _ctx(t0: float, t1: float, events=()) -> SimpleNamespace:
    return SimpleNamespace(t0=t0, t1=t1, devices=[0], events={0: list(events)})


@pytest.fixture
def recorded(monkeypatch):
    """Frames 0-3 at 0, 10, 20, 30 s; the stretch [5, 35] holds frames 1
    and 2 whole."""
    fake = [s for k in range(4) for s in _frame(k, 10.0 * k)]
    fake.append(Span("fetch.wait", None, None, 40.0, 45.0, 0))   # no frame
    monkeypatch.setattr(profiling, "spans", lambda: list(fake))
    return fake


def _read(name, ctx):
    return runner.reader(name).read(ctx)


def test_each_reader_gives_its_time_a_frame(recorded):
    ctx = _ctx(5.0, 35.0)
    assert _read("step_load_ms", ctx) == pytest.approx(2e3)
    assert _read("step_replay_ms", ctx) == pytest.approx(1e3)
    assert _read("fetch_wait_ms", ctx) == pytest.approx(3e3)
    assert _read("copy_wait_ms", ctx) == 0.0


def test_frames_partly_outside_the_stretch_are_left_out(recorded):
    # frame 1 alone lies wholly in [9, 29]
    assert _read("step_load_ms", _ctx(9.0, 29.0)) == pytest.approx(2e3)
    assert set(spans_mod.frames(_ctx(9.0, 29.0))) == {(0, 1)}
    assert _read("fetch_wait_ms", _ctx(11.0, 19.0)) is None


def test_copy_wait_counts_only_the_waits_overlap_with_copies(recorded):
    """Frame 1 waits over [16, 19], frame 2 over [26, 29]. A device-to-host
    copy 15-17 overlaps 1 s of frame 1's wait, one 27-28 and another
    27.5-30 (their union 27-29) 2 s of frame 2's; a kernel and a
    host-to-device copy inside the waits do not count."""
    events = [(DTOH, 15.0, 17.0), (DTOH, 27.0, 28.0), (DTOH, 27.5, 30.0),
              ("bars_raster_kernel", 17.0, 19.0),
              ("Memcpy HtoD (Pinned -> Device)", 18.0, 19.0)]
    assert _read("copy_wait_ms", _ctx(5.0, 35.0, events)) == pytest.approx(1.5e3)


def test_copy_wait_is_the_sum_over_every_wait_and_copy(monkeypatch):
    """Many frames, each with a wait, and copies on two cards that overlap
    one another and the waits anyhow: the reader's walk over the sorted
    copies gives the overlap of every wait with the copies' union."""
    rng = np.random.default_rng(7)
    fake, waits = [], []
    for k in range(200):
        t = 10.0 * k
        a = t + rng.uniform(1, 5)
        b = a + rng.uniform(0, 4)
        fake += [Span("fetch.wait", 0, k, a, b, 0), Span("frame", 0, k, t, t + 10, 0)]
        waits.append((a, b))
    monkeypatch.setattr(profiling, "spans", lambda: list(fake))
    events = {}
    for d in (0, 1):
        starts = rng.uniform(0, 2000, 300)
        events[d] = [(DTOH, s, s + rng.uniform(0, 6)) for s in starts]
        events[d].append(("kernel", 0.0, 2000.0))
    ctx = SimpleNamespace(t0=0.0, t1=2000.0, devices=[0, 1], events=events)
    grid = np.arange(0.0, 2000.0, 1e-3) + 5e-4       # 1 ms cells
    copying = np.zeros(grid.shape, bool)
    for d in (0, 1):
        for _, s, e in events[d][:-1]:
            copying |= (grid >= s) & (grid < e)
    waiting = np.zeros(grid.shape, bool)
    for a, b in waits:
        waiting |= (grid >= a) & (grid < b)
    want = (copying & waiting).sum() * 1e-3 / 200 * 1e3
    assert _read("copy_wait_ms", ctx) == pytest.approx(want, rel=2e-3)


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_gives_nothing_without_a_stretch(metric, recorded):
    assert _read(metric, _ctx(0.0, 0.0)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_a_program_without_the_recorder_gives_nothing(metric, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert _read(metric, _ctx(5.0, 35.0)) is None


def _bursts(events, idle: float = 5e-6) -> list:
    """The kernels that begin after the card was idle (no kernel or copy
    running) for ``idle`` seconds or more: work that a host call enqueued
    just before. A graph's kernels follow one another closer than that
    (0.005-0.4 us on the card), so the kernels of a frame's replay that
    still run when the next frame begins are not taken. -> (start, idle
    time before it, its name, the name of the event before it)."""
    out, busy, last = [], -np.inf, None
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        if s - busy >= idle and not trace_mod.is_copy(name):
            out.append((s, s - busy, name, last))
        if e > busy:
            busy, last = e, name
    return out


def traced_run(cell: str, seconds: float) -> dict:
    """One traced run of ``cell`` on card 0, in this process (its first
    profiler session: a later one in the same process can place the
    device events a millisecond off), and what its whole frames show:
    the line's per-layer metrics, frames whose children outlast their
    parent, kernels that start on an idle card (``_bursts``) inside a
    frame before that frame's replay began and the gaps of the others,
    and the device events that bear a span's name."""
    cell_entry, config, traffic = runner.cell_files(cell)
    kept = {}
    real = runner._layer_context

    def keep(*args):
        kept["ctx"] = real(*args)
        return kept["ctx"]

    runner._layer_context = keep
    close = trace_mod.Stretch.close

    def close_and_keep(stretch):
        kept["offsets"] = stretch.offsets
        close(stretch)

    trace_mod.Stretch.close = close_and_keep
    per_layer = [m for m in runner.manifest()["per_layer"]
                 if cell in m.get("workloads", [cell])]
    out = runner.run_cell(cell_entry, config, traffic, helpers.SEED, seconds,
                          True, ["cuda:0"], time.perf_counter(),
                          per_layer=per_layer)
    ctx = kept["ctx"]
    frames = spans_mod.frames(ctx) or {}
    bursts = _bursts(ctx.events[ctx.devices[0]])
    starts = np.array([b[0] for b in bursts])
    over, early, gaps = 0, [], []
    for kinds in frames.values():
        total = {k: sum(e - s for s, e in v) for k, v in kinds.items()}
        over += (total.get("step.load", 0) + total.get("step.replay", 0)
                 > total["step"])
        over += (total.get("fetch.copy", 0) + total.get("fetch.wait", 0)
                 > total["fetch"])
        if "step.replay" not in kinds:
            continue        # a capture's frame
        (f0, f1), = kinds["frame"]
        replay = min(s for s, _ in kinds["step.replay"])
        lo, hi = np.searchsorted(starts, [f0, f1], side="left")
        for b, idle, name, before in bursts[lo:hi]:
            if b < replay:
                early.append({"before_us": (replay - b) * 1e6,
                              "idle_us": idle * 1e6, "kernel": name[:80],
                              "after": (before or "")[:80],
                              "from_frame_start_us": (b - f0) * 1e6})
            else:
                gaps.append(b - replay)
    names = {n for evs in ctx.events.values() for n, _, _ in evs}
    recorded = profiling.spans()
    starts = [s.start for s in recorded if s.kind == "frame"]
    offsets = kept.get("offsets", [])
    return {"metrics": {k: v["value"] for k, v in out["line"]["metrics"].items()},
            "stretch_s": ctx.t1 - ctx.t0, "spans": len(recorded),
            "frame_spans": len(starts),
            "frame_starts_from_t0_s": [min(starts) - ctx.t0,
                                       max(starts) - ctx.t0] if starts else None,
            "frames": len(frames), "children_over_parent": over,
            "before_replay": early, "bursts": len(gaps),
            "min_gap_us": min(gaps) * 1e6 if gaps else None,
            "smallest_gaps_us": sorted(g * 1e6 for g in gaps)[:5],
            "clock_offset_drift_us": (offsets[-1] - offsets[0]) * 1e6
            if len(offsets) > 1 else None,
            "span_names_in_trace": sorted(names & KINDS)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rc_bars.live", "fleet_native4.s64"])
def test_traced_cell_on_the_card_reports_the_spans_on_the_trace_clock(
        cell, capsys):
    """A traced run of the cell as the benchmark makes it (51 s: a
    process's first profiler session takes seconds to open), in a process
    of its own: the four metrics are read; in each whole frame of the
    stretch the children sum to no more than their parent; no kernel that
    starts on an idle card inside a frame starts before that frame's
    replay began (the clock check; the smallest gap is printed); and no
    device event bears a span's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs on the card")
    run = subprocess.run([sys.executable, __file__, cell, "51"],
                         cwd=helpers.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    assert set(METRICS) <= {k.split(".", 1)[0] for k in res["metrics"]}, res
    assert res["frames"] > 0 and res["bursts"] > 0
    assert res["children_over_parent"] == 0
    assert res["before_replay"] == [], res
    assert res["span_names_in_trace"] == []
    with capsys.disabled():
        print(f"\n{cell}: {res}")


if __name__ == "__main__":
    print(json.dumps(traced_run(sys.argv[1], float(sys.argv[2]))))

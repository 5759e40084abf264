"""The metric arithmetic: a rate over the whole window, a percentile over
every sample, busy time as a union of intervals, the bounds' spread, and
the rooflines' counts against the numbers the port's own timers gave."""

import statistics

import numpy as np
import pytest

import helpers  # noqa: F401  (the harness on the path)
from benchlib import roofline, stats


def test_rate_is_all_work_over_all_time():
    assert stats.rate(3000, 20.0) == 150.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_over_every_sample():
    rng = np.random.default_rng(0)
    chunks = [rng.exponential(1.0, n) for n in (10, 1000, 37)]
    every = np.concatenate(chunks)
    assert stats.percentile(every, 95) == np.percentile(every, 95)
    # not a median of the chunks' own percentiles
    per_chunk = np.median([np.percentile(c, 95) for c in chunks])
    assert stats.percentile(every, 95) != per_chunk
    with pytest.raises(ValueError):
        stats.percentile([], 95)


@pytest.mark.parametrize("spans, lo, hi, want", [
    ([(0, 1), (2, 3)], None, None, 2.0),
    ([(0, 2), (1, 3)], None, None, 3.0),          # overlap counts once
    ([(0, 4), (1, 2)], None, None, 4.0),          # nested
    ([(0, 2), (1, 3), (5, 6)], 1.5, 5.5, 2.0),    # clipped to the window
    ([], 0, 1, 0.0),
])
def test_busy_is_a_union_not_a_sum(spans, lo, hi, want):
    assert stats.union_length(spans, lo, hi) == pytest.approx(want)


def test_gaps_complement_the_union():
    spans = [(1, 2), (1.5, 3), (4, 5)]
    g = stats.gaps(spans, 0, 6)
    assert g == [(0, 1), (3, 4), (5, 6)]
    assert stats.union_length(spans, 0, 6) + sum(b - a for a, b in g) == 6


def test_spread_is_iqr_over_median():
    v = [10, 11, 12, 13, 14, 15]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_rooflines_match_the_ports_timer_arithmetic():
    # the bounds PR 15's chip call printed for these shapes (PERF.md's
    # kernel table): the update at n 4096, B 2 and 128, F 6 (the smoke's
    # history depth); the bars raster at S 64, 800x600, a colour row a
    # stream
    assert roofline.update_bound_s(4096, 2, 6) * 1e6 == pytest.approx(0.103, abs=5e-4)
    assert roofline.update_bound_s(4096, 128, 6) * 1e6 == pytest.approx(6.266, abs=5e-4)
    assert roofline.raster_bound_s(64, 600, 800, 64) * 1e6 == pytest.approx(147.15, abs=5e-3)


K, HTOD, DTOD = "raster_kernel", "Memcpy HtoD (Pinned -> Device)", "Memcpy DtoD (Device -> Device)"
DTOH = "Memcpy DtoH (Device -> Pinned)"


@pytest.mark.parametrize("events, want", [
    # the compute stream (kernels and the copies it runs) outlasts the
    # device-to-host copies that run beside it
    ([(K, 1.0, 5.0), (HTOD, 0.5, 1.0), (DTOD, 5.0, 5.5), (DTOH, 5.5, 8.0)],
     5.0),
    # the device-to-host copies outlast it
    ([(K, 1.0, 2.0), (DTOH, 2.0, 6.0), (DTOH, 6.0, 7.5)], 5.5),
    # what starts before the trace's first frame is left out
    ([(K, -3.0, -1.0), (K, 1.0, 2.0), (DTOH, -1.0, 0.5)], 1.0),
    ([], 0.0),
])
def test_card_time_is_the_busier_of_compute_and_copy_out(events, want):
    from benchlib import trace

    assert trace.card_time(events, 0.0) == pytest.approx(want)


def test_card_rate_is_stream_frames_over_the_slowest_cards_time():
    from types import SimpleNamespace

    from benchlib import runner

    rec = SimpleNamespace(steps=[(t, t + 0.1) for t in (-2.0, 1.0, 2.0, 3.0)])
    events = {0: [(K, 1.0, 1.004), (K, 2.0, 2.004), (K, 3.0, 3.004)],
              1: [(K, 1.0, 1.005), (K, 2.0, 2.005), (DTOH, 3.0, 3.005)]}
    stretch = SimpleNamespace(t0=0.0, t1=4.0, done=True, events=events,
                              devices=["cuda:0", "cuda:1"])
    # three frames after the trace opened: card 0 12 ms of kernels for
    # them, card 1 10 ms (its 5 ms copy out runs beside them)
    assert runner.card_rate(stretch, rec, 64) == pytest.approx(64 * 3 / 0.012)
    assert runner.card_rate(None, rec, 64) is None
    assert runner.card_rate(SimpleNamespace(done=False), rec, 64) is None
    empty = SimpleNamespace(t0=0.0, done=True, events={},
                            devices=["cuda:0"])
    assert runner.card_rate(empty, rec, 64) is None

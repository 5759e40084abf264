"""The readers of ``graph_kernels_per_frame`` and ``table_lookup_roofline``
on hand-built contexts: the mean ``step.replay`` payload over the
stretch's whole frames, and the table lookup's least time over its mean
profiler time a launch; each gives nothing where there is nothing to
read (no stretch, no whole frame, replays that carry no count, no
launch of the kernel)."""

from types import SimpleNamespace

import pytest

import helpers  # noqa: F401  (the harness on the path)
from benchlib import lookup_roofline, roofline, runner
from glava_tpu_torch.utils import profiling
from glava_tpu_torch.utils.profiling import Span

LOOKUP = "void (anonymous namespace)::table_lookup_kernel<true>(float const*, int const*, float*, int, long long)"
SHAPES = {"n": 4096, "H": 1080, "W": 1920}


def _frame(k: int, t: float, kernels: int) -> list:
    return [Span("step.replay", 0, k, t + 1, t + 2, kernels),
            Span("step", 0, k, t + 1, t + 3, 0),
            Span("frame", 0, k, t, t + 10, 0)]


def _ctx(t0, t1, events=(), shapes=SHAPES):
    return SimpleNamespace(t0=t0, t1=t1, devices=[0], events={0: list(events)},
                           shapes=dict(shapes))


def _read(name, ctx):
    return runner.reader(name).read(ctx)


@pytest.fixture
def replays(monkeypatch):
    """Frames 0-3 at 0, 10, 20, 30 s, their replays carrying 40, 40, 55
    and 40 kernels; frame 2 replays twice (a second branch's graph: 55
    and 12)."""
    fake = [s for k, n in enumerate((40, 40, 55, 40))
            for s in _frame(k, 10.0 * k, n)]
    fake.append(Span("step.replay", 0, 2, 24.0, 25.0, 12))
    monkeypatch.setattr(profiling, "spans", lambda: list(fake))
    return fake


def test_graph_kernels_per_frame_is_the_mean_payload(replays):
    # frames 1 and 2 lie wholly in [5, 35]: (40 + 55 + 12) / 2
    assert _read("graph_kernels_per_frame", _ctx(5.0, 35.0)) == \
        pytest.approx(53.5)
    assert _read("graph_kernels_per_frame", _ctx(-1.0, 10.0)) == 40.0


def test_graph_kernels_per_frame_gives_nothing_without_a_count(monkeypatch,
                                                              replays):
    assert _read("graph_kernels_per_frame", _ctx(0.0, 0.0)) is None
    assert _read("graph_kernels_per_frame", _ctx(11.0, 19.0)) is None
    # a program whose replays carry no count (the CPU, or one that
    # predates the count)
    zero = [s._replace(payload=0) for s in replays]
    monkeypatch.setattr(profiling, "spans", lambda: list(zero))
    assert _read("graph_kernels_per_frame", _ctx(5.0, 35.0)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read("graph_kernels_per_frame", _ctx(5.0, 35.0)) is None


def test_lookup_bytes_are_its_plane_table_and_output():
    P = 1920 * 1080
    assert lookup_roofline.lookup_bytes(1, 4096, P) == P * 4 + 4096 * 4 + P * 4
    assert lookup_roofline.lookup_bound_s(2, 10, 100) == pytest.approx(
        (400 + 80 + 800) / roofline.HBM_BYTES_PER_S)


def test_table_lookup_roofline_over_the_mean_launch():
    bound = lookup_roofline.lookup_bound_s(1, 4096, 1920 * 1080)
    events = [(LOOKUP, 1.0, 1.0 + 2 * bound), (LOOKUP, 5.0, 5.0 + 6 * bound),
              ("fused_update_kernel", 2.0, 3.0), ("Memcpy DtoH", 3.0, 4.0)]
    assert _read("table_lookup_roofline", _ctx(0.0, 9.0, events)) == \
        pytest.approx(25.0)


def test_table_lookup_roofline_gives_nothing_without_a_launch():
    assert _read("table_lookup_roofline", _ctx(0.0, 0.0)) is None
    others = [("fused_update_kernel", 2.0, 3.0), ("Memcpy DtoH", 3.0, 4.0)]
    assert _read("table_lookup_roofline", _ctx(0.0, 9.0, others)) is None

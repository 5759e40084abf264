"""One run of one cell: inputs from the seed, the system under test from
its driver, warm-up, the measured window, the check, the metrics.

Everything a cell needs is found by name: the configuration's file
(``BENCHMARK.json``'s ``configs[].file``), the traffic mix
(``traffic/<mix>.json``), the driver the mix or else the configuration
names (``drivers/<driver>.py``) and one reader a per-layer metric
(``metrics/<metric>.py``, ``read(ctx) -> float | None``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchlib import check, pcm as pcm_mod, stats, trace as trace_mod

HERE = Path(__file__).resolve().parents[1]          # the benchmark's folder
ROOT = HERE.parent
JAX_MODULES = ("jax", "jaxlib", "flax", "glava_tpu")
perf = time.perf_counter


class JaxLoaded(RuntimeError):
    """The process that prints the result holds JAX or the JAX package."""


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(name: str, bench: dict | None = None) -> tuple:
    """(workload entry, configuration, traffic mix) of cell ``name``."""
    bench = bench or manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return cell, config, traffic


def _load(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _load("drivers", name)


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, or for a quantity
    split by the cells that read it (``<quantity>.<part>``, as
    ``fetch_ms.fleet``) with no file of its own, its quantity's."""
    if "." in metric and not (HERE / "metrics" / f"{metric}.py").is_file():
        metric = metric.split(".", 1)[0]
    return _load("metrics", metric)


def jax_loaded() -> list[str]:
    """The modules of ``JAX_MODULES`` in ``sys.modules``, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_MODULES))


def _sample_plan(system, traffic: dict, seed: int) -> dict:
    """stream -> fractions of the window at which a frame is kept for the
    check: ``check.streams`` streams spread over every module in turn,
    ``check.frames`` each, drawn from the seed."""
    rng = np.random.default_rng([seed & ((1 << 63) - 1), 5])
    groups: dict = {}
    for s, m in enumerate(system.modules):
        groups.setdefault(m, []).append(s)
    pools = [list(rng.permutation(v)) for _, v in sorted(groups.items())]
    want = min(int(traffic["check"]["streams"]), len(system.sinks))
    chosen: list = []
    while len(chosen) < want:
        for p in pools:
            if p and len(chosen) < want:
                chosen.append(int(p.pop()))
    nf = int(traffic["check"]["frames"])
    return {s: np.sort(rng.uniform(0.05, 0.95, nf)) for s in chosen}


def _record(rec, system, pcm: np.ndarray, hop: int,
            plan: dict) -> check.RunRecord:
    """What the check reads of the run: each frame's snapshots resolved
    to hop counts, flags, times, gravity steps and measured rates, the
    sampled frames, and the counts of what did not pair, resolve or
    arrive."""
    S = len(system.sinks)
    counts = {"unpaired": 0, "unresolved": 0, "missing": 0}
    lens = [len(r) for r in rec.snaps]
    K = min(lens + [len(rec.steps)])
    for s in range(S):
        counts["unpaired"] += (abs(lens[s] - len(system.sinks[s].stamps))
                               + abs(lens[s] - len(rec.steps)))
    pushes = np.empty((K, S), np.int64)
    mods = np.empty((K, S), bool)
    for s, r in enumerate(rec.snaps):
        r = r[:K]
        c0 = np.array([x[2] for x in r], np.int64)
        c1 = np.array([x[3] for x in r], np.int64)
        fp = np.array([(x[4], x[5]) for x in r], np.float32).reshape(-1, 2)
        n = check.resolve(pcm, s, c0, c1, fp, hop)
        counts["unresolved"] += int((n < 0).sum())
        pushes[:, s] = np.where(n < 0, c0, n)
        mods[:, s] = [x[6] for x in r]
    gravity = np.empty((K, S), np.float32)
    ups = np.empty((K, S), np.float64)
    ticks = np.zeros(K, bool)
    for k, st in enumerate(rec.steps[:K]):
        gravity[k] = np.asarray(st[2], np.float32)
        ups[k] = np.asarray(st[4], np.float64)
        ticks[k] = k > 0 and st[4] is not rec.steps[k - 1][4]
    times = np.array([st[:2] for st in rec.steps[:K]], np.float64).reshape(K, 2)
    samples = [(s, k, f) for s, sink in enumerate(system.sinks)
               for k, f in sink.samples if k < K]
    counts["missing"] = sum(len(v) for v in plan.values()) - sum(
        system.sinks[s].met for s in plan)
    return check.RunRecord(system.modules, system.pipe, pushes, mods, gravity,
                           times, ticks, ups, list(rec.runs), samples, {},
                           counts)


def _window_metrics(rec, system, t0: float, t1: float) -> tuple:
    """(stream frames handed off in [t0, t1], their latencies in ms)."""
    n, lat = 0, []
    for s, sink in enumerate(system.sinks):
        st = np.asarray(sink.stamps)
        sn = np.asarray([x[0] for x in rec.snaps[s]])
        k = min(len(st), len(sn))
        inside = (st[:k] >= t0) & (st[:k] <= t1)
        n += int(((st >= t0) & (st <= t1)).sum())
        lat.append((st[:k] - sn[:k])[inside] * 1e3)
    return n, np.concatenate(lat) if lat else np.zeros(0)


def _layer_context(rec, system, t_start: float, t_end: float,
                   stretch) -> SimpleNamespace:
    """What a metric reader gets. Host side: the spans, and each
    stream-frame's time from snapshot to hand-off, over the window up to
    the moment the profiler began to open (the whole window where none
    did), where the loop runs as in an untraced run; after that the
    profiler's session has slowed it. Device side: the trace of the
    stretch, when there is one."""
    spans = {"step": [(a, b) for a, b, *_ in rec.steps],
             "fetch": list(rec.fetches),
             "snapshot": [(x[0], x[1]) for r in rec.snaps for x in r]}
    traced = stretch is not None and stretch.done
    regions = [(t_start, stretch.t_open if traced else t_end)]
    regions = [(a, b) for a, b in regions if b > a]
    starts = np.array([a for a, *_ in rec.steps])

    def frames_in(lo, hi):
        return int(((starts >= lo) & (starts < hi)).sum())

    def span_s(name):
        iv = np.asarray(spans[name], np.float64).reshape(-1, 2)
        return float(sum(np.clip(np.minimum(iv[:, 1], z)
                                 - np.maximum(iv[:, 0], y), 0.0, None).sum()
                         for y, z in regions))

    handed = [_window_metrics(rec, system, a, b) for a, b in regions]
    lat = [h[1] for h in handed]
    devs = [d.index if d.index is not None else 0 for d in system.devices]
    t0, t1 = (stretch.t0, stretch.t1) if traced else (0.0, 0.0)
    events = {d: stretch.events.get(d, []) if traced else [] for d in devs}
    return SimpleNamespace(
        host_s=sum(b - a for a, b in regions),
        host_frames=sum(frames_in(a, b) for a, b in regions),
        span_s=span_s, spans=spans,
        latency_ms=np.concatenate(lat) if lat else np.zeros(0),
        handed=sum(h[0] for h in handed),
        t0=t0, t1=t1, frames=frames_in(t0, t1) if traced else 0,
        devices=devs, events=events,
        view=trace_mod.device_view(events, t0, t1) if traced else {},
        shapes=system.shapes)


def card_rate(stretch, rec, streams: int) -> float | None:
    """Stream-frames a second of card time: the streams over the card
    time a frame (``trace.card_time``) of every frame stepped after the
    whole-window trace opened, the slowest card's where there are
    several; None without a trace or a frame in it."""
    if stretch is None or not stretch.done:
        return None
    frames = sum(a >= stretch.t0 for a, *_ in rec.steps)
    devs = [torch.device(d) for d in stretch.devices]
    worst = max((trace_mod.card_time(
        stretch.events.get(d.index if d.index is not None else 0, []),
        stretch.t0) for d in devs), default=0.0)
    if not frames or worst <= 0:
        return None
    return streams * frames / worst


def run_cell(cell: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, devices: list, t_proc: float,
             per_layer: list | None = None, control: bool = False,
             pins: dict | None = None, end_to_end: list | None = None) -> dict:
    """One run; returns the result (``line``: the JSON object to print,
    ``check``: the compared numbers and limits, ``readings``). The
    untraced line carries the end-to-end metrics ``end_to_end`` (by
    default those ``BENCHMARK.json`` gives the cell). With
    ``pins`` (``benchlib.cores.split``) the loop's thread runs on the
    core ``pins["loop"]`` alone and the feeder on ``pins["feeder"]``.
    Where an end-to-end metric comes from the device trace, the untraced
    run profiles the cards over its whole window (a traced run profiles
    a stretch of it for the per-layer metrics); on the CPU it is left
    out."""
    if end_to_end is None:
        end_to_end = [m for m in manifest()["end_to_end"]
                      if cell["name"] in m.get("workloads", [cell["name"]])]
    marks = {"start": perf()}
    S = int(traffic["streams"])
    dsp = config["dsp"]
    rate, hop = int(dsp["sample_rate"]), int(dsp["samplesize"]) // 4
    warm = float(traffic["warmup_s"])
    n_samples = int((warm + seconds + 30) * rate) + int(dsp["bufsize"])
    cuda = torch.device(devices[0]).type == "cuda"
    pcm = pcm_mod.make_pcm(seed, S, n_samples, rate, device=devices[0])
    if cuda:
        for d in devices:
            torch.cuda.synchronize(d)
        torch.cuda.empty_cache()
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    marks["pcm"] = perf()
    # the program is imported here, not with this module: the reference's
    # side (check, pcm, stats) stays free of it
    from benchlib import live

    live.install(pcm, core=pins["feeder"] if pins else None)
    rec = live.Recorder(S)
    system = driver(traffic.get("driver", config["driver"])).build(
        config, traffic, rec, devices, seed)
    marks["build"] = perf()
    if pins:
        # threads the loop spawns from here on (the capture threads)
        # start on this core too; the feeder moves to its own
        os.sched_setaffinity(0, {pins["loop"]})
    rec.begin_run()
    system.warm(warm)
    marks["warm"] = perf()
    plan = _sample_plan(system, traffic, seed)
    stretch = None
    # what set-up made stays out of the collector's passes in the window
    gc.collect()
    gc.freeze()
    cpu0 = time.thread_time()
    t_start = perf()
    for s, fr in plan.items():
        system.sinks[s].sample_at = list(t_start + fr * seconds)
    if trace:
        tr = traffic["trace"]
        stretch = trace_mod.Stretch(system.devices,
                                    t_start + tr["start"] * seconds,
                                    tr["seconds"])
        rec.on_step = stretch.hook if cuda else None
    elif cuda and any(m["source"] == "device_trace" for m in end_to_end):
        # opened before the window's first step, closed after its last
        stretch = trace_mod.Stretch(system.devices, t_start, float("inf"))
        rec.on_step = stretch.hook
    rec.begin_run()
    system.window(seconds)
    t_end = perf()
    loop_cpu = time.thread_time() - cpu0
    rec.on_step = None
    if stretch is not None and stretch.prof is not None:
        stretch.close()
    peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
            if cuda else 0)
    found = jax_loaded()
    if found:
        raise JaxLoaded(f"the run loaded {', '.join(found)}; no result")
    record = _record(rec, system, pcm, hop, plan)
    record.state = system.state()
    gc.unfreeze()
    frames, lat = _window_metrics(rec, system, t_start, t_end)
    by_second = np.histogram(
        np.concatenate([np.asarray(k.stamps) for k in system.sinks]),
        bins=np.arange(t_start, t_end + 1.0, 1.0))[0]
    ctx = _layer_context(rec, system, t_start, t_end, stretch) if trace else None
    kind = torch.cuda.get_device_name(system.devices[0]) if cuda else "cpu"
    n_dev = len(system.devices)
    system.close()
    system = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = perf()
    readings = check.judge(record, pcm, config, devices[0], control=control)
    t_ref = perf() - t_ref
    ok = check.verdict(readings["program"])
    metrics = {}
    if not trace:
        values = {"stream_frames_per_s": lambda: stats.rate(frames,
                                                            t_end - t_start),
                  "frame_p95_ms": lambda: stats.percentile(lat, 95),
                  "setup_s": lambda: t_start - t_proc,
                  "card_stream_frames_per_s": lambda: card_rate(stretch, rec,
                                                                S)}
        for m in end_to_end:
            v = values[m["name"]]()
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": n_dev, "memory_peak_bytes": int(peak)}
    line = {"correct": ok, "attempted": frames,
            "failed": record.counts["unpaired"] + record.counts["missing"],
            "metrics": metrics, "device": device}
    if ctx is not None:
        for m in per_layer or []:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if ctx.view:
            busy = [ctx.view[d]["busy"] for d in ctx.devices]
            device["busy_s"] = sum(busy) / len(busy)
            device["window_s"] = ctx.t1 - ctx.t0
            line["breakdown"] = trace_mod.breakdown(
                ctx.events, ctx.t0, ctx.t1,
                {k: ctx.spans[k] for k in ("step", "fetch", "snapshot")})
        line["traced_end_to_end"] = {
            "stream_frames_per_s": stats.rate(frames, t_end - t_start),
            "frame_p95_ms": stats.percentile(lat, 95)}
    if control:
        line["control"] = readings["control"]
    chk = {k: [readings["program"][k], lim] for k, lim in check.LIMITS.items()}
    line["check"] = chk
    return {"line": line, "check": chk, "readings": readings,
            "by_second": by_second.tolist(),
            "loop_cpu_share": loop_cpu / (t_end - t_start),
            "reference_s": t_ref,
            "setup_parts": {"imports": marks["start"] - t_proc,
                            "inputs": marks["pcm"] - marks["start"],
                            "build": marks["build"] - marks["pcm"],
                            "warm-up": marks["warm"] - marks["build"],
                            "rest": t_start - marks["warm"]}}

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more (every failed check raises, so the exit
code is non-zero and no result line is printed):

1. device    — needs ``torch.cuda.is_available()``; prints the card's
               name and power limit (nvidia-smi).
2. build     — builds both CUDA kernels from ``csrc/`` (fused_update,
               table_lookup), the nvcc runs side by side.
3. kernel    — each kernel vs its plain torch version on the card.
               fused_update at n in {256, 1024, 4096, 16384}, F = 6,
               B in {2, 128}: 8 updates of fresh audio with staggered
               per-row slots; gravity, average and the written history
               slot within 2e-5, the other history slots bit-identical.
               table_lookup BIT-IDENTICAL (torch.equal) on: radial's
               162-entry table at its 1920x1080 id plane, an 8192-entry
               table at circle's three 1920x1080 site planes, a
               32768-entry table (the dynamic shared memory path), a
               random 2M-point plane, a 97-point plane and a (3, T)
               table; an out-of-range static plane must raise.
4. main path — ``Engine`` with the synth backend and a null sink, the
               kernel counts set to 0 just before each run and read
               just after: bars (the shipped rc.glsl) at 800x600 and
               1920x1080, radial and circle at 800x600 and 1920x1080
               (bufsize 4096), wave and graph at 800x600. fused_update
               launches must equal the audio updates of fft modules,
               table_lookup launches the frames of radial and circle (one
               a frame). ``Engine.run_tests()`` (test_rc.glsl) must pass
               on cuda. Every module's frame after 24 updates of fixed
               stereo tones renders on cuda and cpu at 800x600 and must
               meet the golden rule (under 0.2% of pixels more than 2 LSB
               apart), and at tests/golden/frames.npz's size against the
               archive.
5. times     — device times (torch.profiler) of the fused update and
               of the lookup on circle's 1080p planes, kernel and plain;
               CUDA-event frame times of bars, radial and circle at
               800x600 and 1920x1080; a profiler breakdown of bars at
               800x600 and circle at 1920x1080.

The second-to-last line is the kernels JSON, the last the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL = 2e-5           # spectra (the JAX suite's fused-vs-unfused tolerance)
ROOT = Path(__file__).resolve().parent
KERNELS = ("fused_update", "table_lookup")
MODULES = ("bars", "radial", "circle", "wave", "graph", "test")


def golden_rule(got: np.ndarray, want: np.ndarray) -> float:
    """Share of pixels more than 2 LSB apart; must stay under 0.002."""
    if got.shape != want.shape:
        raise AssertionError(f"frame shapes differ: {got.shape} vs {want.shape}")
    return float((np.abs(got.astype(np.int16) - want.astype(np.int16)) > 2).mean())


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events,
    after a warm-up)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"[1 device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return card


def phase_build():
    from glava_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.load_all(KERNELS)
    total = time.perf_counter() - t0
    for name, b in built.items():
        ptxas = " | ".join(ln.strip() for ln in b.log.splitlines()
                           if "registers" in ln or "smem" in ln)
        print(f"[2 build] {name}: nvcc {b.seconds:.2f} s, {b.path.name}; "
              f"{ptxas or 'no ptxas log'}")
    print(f"[2 build] both kernels built and loaded in {total:.2f} s")


def _case(n: int, B: int, F: int, rng) -> float:
    from glava_tpu_torch.ops import fused, windows

    dev = torch.device("cuda")
    m = n // 2
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    window = t(windows.pcm_window(n))
    w_age = t(fused.age_weights(windows.avg_weights(F, True, True)))
    grav = t(rng.uniform(0, 1, (B, 2, m)))
    hist = t(rng.uniform(0, 1, (B, F, 2, m)))
    count = np.arange(B) % F                  # staggered per-row slots
    worst = 0.0
    for _ in range(8):
        pcm = t(rng.standard_normal((B, n)) * 0.3)
        scale = t(rng.uniform(5.0, 20.0, B))
        cutoff = t(rng.uniform(0.0, 0.5, B))
        g = t(rng.uniform(0.01, 0.1, B))
        slot = t(count, torch.int32)
        pg, ph, pavg = fused.fused_update_plain(
            pcm, grav, hist, slot, scale, cutoff, g, window, w_age)
        kg, kh, kavg = fused.fused_update(
            pcm, grav.clone(), hist.clone(), slot, scale, cutoff, g,
            window, w_age)
        torch.cuda.synchronize()
        written = torch.zeros((B, F), dtype=torch.bool, device=dev)
        written[torch.arange(B, device=dev), slot.long()] = True
        errs = {
            "grav": (kg - pg).abs().max().item(),
            "avg": (kavg - pavg).abs().max().item(),
            "slot": (kh[written] - ph[written]).abs().max().item(),
        }
        if not torch.equal(kh[~written], hist[~written]):
            raise AssertionError(f"n={n} B={B}: unwritten history slots changed")
        if not all(np.isfinite(v) and v <= TOL for v in errs.values()):
            raise AssertionError(f"n={n} B={B}: kernel vs plain {errs} > {TOL}")
        worst = max(worst, *errs.values())
        grav, hist = kg, kh
        count = (count + 1) % F
    torch.cuda.synchronize()
    return worst


def phase_kernel() -> float:
    rng = np.random.default_rng(0)
    worst = 0.0
    cases = []
    for n in (256, 1024, 4096, 16384):
        for B in (2, 128):
            err = _case(n, B, 6, rng)
            cases.append(f"n{n}/B{B} {err:.2e}")
            worst = max(worst, err)
    print(f"[3 kernel] fused_update vs plain, max abs err per case: "
          f"{', '.join(cases)} (tolerance {TOL})")
    return worst


def _module_lookup(module: str, screen, reqs=()):
    """The StaticLookup a module builds (its real index plane)."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    r = Renderer(loader.load(cli_requests=reqs, force_module=module),
                 screen=screen, device="cuda")
    (lk,) = r.module.lookups
    return lk


def phase_lookup() -> float:
    """table_lookup vs table_lookup_plain, bit for bit."""
    from glava_tpu_torch.ops import lookup

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    radial = _module_lookup("radial", (1920, 1080))
    circle = _module_lookup("circle", (1920, 1080))
    if radial.table_size != 162 or circle.table_size != 8192:
        raise AssertionError(f"tables {radial.table_size}, {circle.table_size}")
    cases = {
        "radial T162 1920x1080": (radial.table_size, radial.idx),
        "circle T8192 3x1920x1080": (circle.table_size, circle.idx),
        "T32768 dyn smem 2x40000": (32768, t(rng.integers(
            0, 32768, (2, 40000)).astype(np.int32))),
        "T8192 random 2M": (8192, t(rng.integers(
            0, 8192, 2_000_000).astype(np.int32))),
        "T256 97 points": (256, t(rng.integers(0, 256, 97).astype(np.int32))),
    }
    worst = 0.0
    names = []
    for name, (T, idx) in cases.items():
        for S in (None, 3):
            tab = t(rng.standard_normal((T,) if S is None else (S, T))
                    .astype(np.float32))
            got = lookup.table_lookup(tab, idx)
            want = lookup.table_lookup_plain(tab, idx)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"table_lookup {name} S={S}: kernel != plain")
            worst = max(worst, (got - want).abs().max().item())
        names.append(name)
    try:
        bad = np.zeros((8, 8), np.int64)
        bad[3, 5] = 162
        lookup.StaticLookup(bad, 162, dev)
    except ValueError:
        pass
    else:
        raise AssertionError("an out-of-range static plane did not raise")
    print(f"[3 kernel] table_lookup vs plain, torch.equal on (T,) and (3, T) "
          f"tables: {'; '.join(names)}; max abs err {worst}; an out-of-range "
          "static plane raises at build")
    return worst


def _fixed_frame(device: str, screen=None, reqs=(), module="bars") -> np.ndarray:
    """The final uint8 frame of 24 updates of fixed stereo tones
    (tests/test_golden.py's input) through the shipped rc.glsl."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    lc = loader.load(cli_requests=reqs, force_module=module)
    r = Renderer(lc, screen=screen, device=device)
    cfg = lc.cfg
    tt = np.arange(cfg.sample_rate) / cfg.sample_rate
    le = (0.4 * np.sin(2 * np.pi * 440.0 * tt)).astype(np.float32)
    ri = (0.4 * np.sin(2 * np.pi * 3000.0 * tt)).astype(np.float32)
    state = r.init_state()
    g = float(np.float32(cfg.gravity_step / cfg.nominal_ups))
    frame = None
    for k in range(24):
        end = (k + 1) * cfg.hop
        snap = np.zeros((2, cfg.bufsize), np.float32)
        for ch, b in enumerate((le, ri)):
            seg = b[max(end - cfg.bufsize, 0):end]
            snap[ch, cfg.bufsize - len(seg):] = seg
        state, frame = r.step_u8(state, snap, True, 0.25, 1.0, g)
    return frame.cpu().numpy()


def _engine_run(frames: int, screen=None, module=None):
    """One main-path run: the counts are set to 0 just before the run
    and read just after it."""
    from glava_tpu_torch.ops import fused, lookup
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import NullSink

    eng = Engine(EngineOptions(audio_backend="synth", screen=screen,
                               force_module=module, device="cuda"),
                 sink=NullSink())
    fused.launches = 0
    lookup.launches = 0
    t0 = time.perf_counter()
    eng.run(max_frames=frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {"fused_update": fused.launches, "table_lookup": lookup.launches}
    name = eng.loaded.module
    w, h = eng.renderer.screen
    if eng.frames_rendered != frames:
        raise AssertionError(f"{name}: engine rendered {eng.frames_rendered} "
                             f"of {frames}")
    fft = name != "wave"
    want = {"fused_update": eng.updates if fft else 0,
            "table_lookup": frames if name in ("radial", "circle") else 0}
    if counts != want or (fft and eng.updates == 0):
        raise AssertionError(f"{name} {w}x{h}: launches {counts}, expected "
                             f"{want} ({eng.updates} updates)")
    print(f"[4 main path] {name} {w}x{h}: {frames} frames, {eng.updates} "
          f"updates, launches {counts}, {frames / dt:.1f} fps host clock")
    return counts


RUNS = (
    ("bars", None, 200), ("bars", (1920, 1080), 120),
    ("radial", None, 200), ("radial", (1920, 1080), 120),
    ("circle", None, 200), ("circle", (1920, 1080), 120),
    ("wave", None, 200), ("graph", None, 200),
)


def phase_main_path() -> dict:
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import NullSink

    totals = dict.fromkeys(KERNELS, 0)
    for module, screen, frames in RUNS:
        counts = _engine_run(frames, screen, module)
        for k in KERNELS:
            totals[k] += counts[k]
    if not all(totals.values()):
        raise AssertionError(f"a kernel of the path never launched: {totals}")
    eng = Engine(EngineOptions(audio_backend="synth", test_mode=True,
                               device="cuda"), sink=NullSink())
    if not eng.run_tests():
        raise AssertionError("--run-tests (test_rc.glsl) failed on cuda")
    print("[4 main path] Engine.run_tests() on test_rc.glsl: PASSED on cuda")

    golden = np.load(ROOT / "tests" / "golden" / "frames.npz")
    sizes = {"bars": (192, 128), "radial": (300, 300), "graph": (192, 128),
             "wave": (192, 128), "circle": (300, 300)}   # test_golden.CASES
    for module in MODULES:
        gpu = _fixed_frame("cuda", module=module)
        cpu = _fixed_frame("cpu", module=module)
        frac = golden_rule(gpu, cpu)
        if frac >= 0.002 or not (gpu[..., 3] > 0).any():
            raise AssertionError(f"{module} cuda vs cpu 800x600: {frac:.4%} off")
        line = f"{module}: cuda vs cpu 800x600 {frac:.4%} px > 2 LSB"
        if module in sizes:
            w, h = sizes[module]
            small = _fixed_frame("cuda", module=module,
                                 reqs=(f"setgeometry 0 0 {w} {h}",))
            gfrac = golden_rule(small, golden[module])
            if gfrac >= 0.002:
                raise AssertionError(f"{module} {w}x{h} vs golden: {gfrac:.4%} off")
            line += f", {w}x{h} vs golden {gfrac:.4%}"
        print(f"[4 main path] {line}")
    return totals


def _update_times(n: int, B: int):
    from glava_tpu_torch.ops import fused, windows

    F = 6
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    args = (
        t(rng.standard_normal((B, n)) * 0.3),
        t(rng.uniform(0, 1, (B, 2, n // 2))),
        t(rng.uniform(0, 1, (B, F, 2, n // 2))),
        t(np.arange(B) % F, torch.int32),
        t(np.full(B, 10.2)), t(np.full(B, 0.3)), t(np.full(B, 0.05)),
        t(windows.pcm_window(n)),
        t(fused.age_weights(windows.avg_weights(F, True, True))),
    )
    kernel = cuda_ms(lambda: fused.fused_update(*args), 500)
    plain = cuda_ms(lambda: fused.fused_update_plain(*args), 200)
    return kernel, plain, device_ms(lambda: fused.fused_update(*args)), \
        device_ms(lambda: fused.fused_update_plain(*args))


def device_ms(fn, iters: int = 100) -> float:
    """Mean device milliseconds per call of ``fn``: the kernels' own
    time from torch.profiler, free of the host's launch overhead that
    an event-timed loop of small launches measures instead."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages())
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return busy / 1e3 / iters


def _lookup_times():
    """Device time per call of the lookup on circle's 1080p planes."""
    from glava_tpu_torch.ops import lookup

    lk = _module_lookup("circle", (1920, 1080))
    tab = torch.as_tensor(np.random.default_rng(4).random(lk.table_size,
                                                          dtype=np.float32),
                          device="cuda")
    return (device_ms(lambda: lookup.table_lookup(tab, lk.idx)),
            device_ms(lambda: lookup.table_lookup_plain(tab, lk.idx)),
            lk.idx.numel())


def _frame_ms(screen, module="bars"):
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    r = Renderer(loader.load(force_module=module), screen=screen, device="cuda")
    rng = np.random.default_rng(2)
    audio = torch.as_tensor(rng.standard_normal((64, 2, 4096)) * 0.3,
                            dtype=torch.float32, device="cuda")
    box = {"s": r.init_state(), "k": 0}

    def frame():
        box["s"], f = r.step_u8(box["s"], audio[box["k"] % 64], True, 0.0,
                                1.0, 0.05)
        box["k"] += 1
        return f.cpu()

    return cuda_ms(frame, 200), r, frame


def _profile(frame, label: str, card: str):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(50):
            frame()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device rows only: an op's row (device type CPU) also carries the
    # device time of the kernels it launched, so summing every row
    # counts most device time twice
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    if busy > 0:
        share = ", ".join(f"{e.key[:48]} {e.self_device_time_total / busy:.0%}"
                          for e in top)
        print(f"[5 times] profile 50 frames {label}: device busy "
              f"{busy / wall_us:.1%} of {wall_us / 50:.0f} us/frame wall, "
              f"{busy / 50:.0f} us/frame device; kernel share: {share} ({card})")
    else:
        print(f"[5 times] profile {label}: no device time recorded (not measured)")


def phase_times(card: str):
    times = {}
    for B in (2, 128):
        times[B] = _update_times(4096, B)
        lk, lp, dk, dp = (v * 1e3 for v in times[B])
        print(f"[5 times] fused update n4096 B{B}: device time kernel "
              f"{dk:.2f} us, plain {dp:.2f} us; event-timed host loop kernel "
              f"{lk:.2f} us, plain {lp:.2f} us ({card})")
    lk_k, lk_p, points = _lookup_times()
    print(f"[5 times] table_lookup circle 1920x1080 ({points} points, T 8192): "
          f"device time kernel {lk_k * 1e3:.2f} us, plain {lk_p * 1e3:.2f} us "
          f"({card})")
    frames = {}
    for module in ("bars", "radial", "circle"):
        ms8, _, f8 = _frame_ms(None, module)
        ms10, _, f10 = _frame_ms((1920, 1080), module)
        frames[module] = (f8, f10)
        print(f"[5 times] {module} frame (update + raster + uint8 + host copy) "
              f"800x600: {ms8:.3f} ms = {1e3 / ms8:.1f} fps; 1920x1080: "
              f"{ms10:.3f} ms = {1e3 / ms10:.1f} fps ({card})")
    _profile(frames["bars"][0], "bars 800x600", card)
    _profile(frames["circle"][1], "circle 1920x1080", card)
    return times[2][2], times[2][3], lk_k, lk_p


def main() -> int:
    card = phase_device()
    phase_build()
    worst = phase_kernel()
    lk_worst = phase_lookup()
    launches = phase_main_path()
    k2, p2, lk_k, lk_p = phase_times(card)
    print(json.dumps({"kernels": [{
        "name": "fused_update",
        "route": "cuda",
        "source": "glava_tpu_torch/csrc/fused_update.cu",
        "replaces": "glava_tpu/ops/pallas/fused.py:712",
        "launches": launches["fused_update"],
        "max_abs_err": worst,
        "ms": k2,
        "plain_ms": p2,
    }, {
        "name": "table_lookup",
        "route": "cuda",
        "source": "glava_tpu_torch/csrc/table_lookup.cu",
        "replaces": "glava_tpu/ops/pallas/lookup.py:53,289,319",
        "launches": launches["table_lookup"],
        "max_abs_err": lk_worst,
        "ms": lk_k,
        "plain_ms": lk_p,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

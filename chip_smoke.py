"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (every failed check raises, so the exit code is
non-zero and no result line is printed):

1. device    — needs ``torch.cuda.is_available()``; prints the card's
               name and power limit (nvidia-smi).
2. build     — builds the fused-update CUDA kernel from ``csrc/``.
3. kernel    — kernel vs its plain torch version on the card, at
               n in {256, 1024, 4096, 16384}, F = 6, B in {2, 128}:
               8 updates of fresh audio with staggered per-row slots;
               gravity, average and the written history slot within
               2e-5, the other history slots bit-identical.
4. main path — the shipped rc.glsl (bars 800x600, bufsize 4096)
               through ``Engine`` with the synth backend and a null
               sink, 300 frames, then 120 frames at 1920x1080; the
               kernel's launch count must equal the updates. A
               fixed-input run renders on cuda and cpu and the final
               frames must meet the golden rule (under 0.2% of pixels
               more than 2 LSB apart), and bars at 192x128 must meet
               it against tests/golden/frames.npz.
5. times     — CUDA-event times of the fused update (kernel and plain)
               and of whole frames at 800x600 and 1920x1080, and a
               torch.profiler breakdown of one frame window.

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
    built = _build.load("fused_update")
    total = time.perf_counter() - t0
    ptxas = " | ".join(ln.strip() for ln in built.log.splitlines()
                       if "registers" in ln or "smem" in ln)
    print(f"[2 build] fused_update: nvcc {built.seconds:.2f} s, load "
          f"{total:.2f} s, {built.path.name}; {ptxas or 'no ptxas log'}")


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
    print(f"[3 kernel] vs plain, max abs err per case: {', '.join(cases)} "
          f"(tolerance {TOL})")
    return worst


def _fixed_frame(device: str, screen=None, reqs=()) -> np.ndarray:
    """The final uint8 frame of 24 updates of fixed stereo tones
    (tests/test_golden.py's input) through the shipped rc.glsl."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    lc = loader.load(cli_requests=reqs, force_module="bars")
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


def _engine_run(frames: int, screen=None):
    from glava_tpu_torch.ops import fused
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import NullSink

    eng = Engine(EngineOptions(audio_backend="synth", screen=screen,
                               device="cuda"), sink=NullSink())
    fused.launches = 0
    t0 = time.perf_counter()
    eng.run(max_frames=frames)
    dt = time.perf_counter() - t0
    launches = fused.launches
    w, h = eng.renderer.screen
    if eng.frames_rendered != frames:
        raise AssertionError(f"engine rendered {eng.frames_rendered} of {frames}")
    if launches != eng.updates or launches == 0:
        raise AssertionError(f"kernel launches {launches} != updates {eng.updates}")
    return launches, eng.updates, frames / dt, w, h


def phase_main_path() -> int:
    launches, updates, fps, w, h = _engine_run(300)
    l2, u2, fps2, w2, h2 = _engine_run(120, screen=(1920, 1080))
    gpu = _fixed_frame("cuda")
    cpu = _fixed_frame("cpu")
    frac = golden_rule(gpu, cpu)
    if frac >= 0.002 or not (gpu[..., 3] > 0).any():
        raise AssertionError(f"cuda vs cpu frame: {frac:.4%} of pixels off")
    small = _fixed_frame("cuda", reqs=("setgeometry 0 0 192 128",))
    golden = np.load(ROOT / "tests" / "golden" / "frames.npz")["bars"]
    gfrac = golden_rule(small, golden)
    if gfrac >= 0.002:
        raise AssertionError(f"bars 192x128 vs golden: {gfrac:.4%} off")
    print(f"[4 main path] engine {w}x{h}: 300 frames, {updates} updates, "
          f"{launches} launches, {fps:.1f} fps host clock; {w2}x{h2}: 120 "
          f"frames, {u2} updates, {l2} launches, {fps2:.1f} fps; cuda vs cpu "
          f"800x600 {frac:.4%} px > 2 LSB; 192x128 vs golden {gfrac:.4%}")
    return launches


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


def _frame_ms(screen):
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    r = Renderer(loader.load(), screen=screen, device="cuda")
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


def phase_times(card: str):
    times = {}
    for B in (2, 128):
        times[B] = _update_times(4096, B)
        lk, lp, dk, dp = (v * 1e3 for v in times[B])
        print(f"[5 times] fused update n4096 B{B}: device time kernel "
              f"{dk:.2f} us, plain {dp:.2f} us; event-timed host loop kernel "
              f"{lk:.2f} us, plain {lp:.2f} us ({card})")
    ms8, _, frame8 = _frame_ms(None)
    ms10, _, _ = _frame_ms((1920, 1080))
    print(f"[5 times] frame (update + bars + uint8 + host copy) 800x600: "
          f"{ms8:.3f} ms = {1e3 / ms8:.1f} fps; 1920x1080: {ms10:.3f} ms = "
          f"{1e3 / ms10:.1f} fps ({card})")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(50):
            frame8()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # self device time sits on the kernels themselves, so it sums
    # without counting a kernel again under the op that launched it
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    if busy > 0:
        share = ", ".join(f"{e.key[:48]} {e.self_device_time_total / busy:.0%}"
                          for e in top)
        print(f"[5 times] profile 50 frames 800x600: device busy "
              f"{busy / wall_us:.1%} of {wall_us / 50:.0f} us/frame wall; "
              f"kernel share: {share} ({card})")
    else:
        print("[5 times] profile: no device time recorded (not measured)")
    return times[2][2], times[2][3]


def main() -> int:
    card = phase_device()
    phase_build()
    worst = phase_kernel()
    launches = phase_main_path()
    k2, p2 = phase_times(card)
    print(json.dumps({"kernels": [{
        "name": "fused_update",
        "route": "cuda",
        "source": "glava_tpu_torch/csrc/fused_update.cu",
        "replaces": "glava_tpu/ops/pallas/fused.py:712",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k2,
        "plain_ms": p2,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's benchmark: FFT windows a second on one card, and the rest
of the JAX package's ``bench.py`` line.

    python -m glava_tpu_torch.bench [--device cuda|cpu] [section ...]

The port of the root ``bench.py`` (sections at its lines 84-672). One
"window" is one stream-update (both channels) of the spectrum update
at the shipped config (bufsize 4096, rc.glsl:190) for a 64-stream
batch. Each section is a function taking its sizes and counts (the
defaults are the JAX bench's) and returning its keys of the line;
:func:`main` runs every section, or the named ones (:data:`SECTIONS`),
and prints ONE JSON line on stdout, last; everything else goes to
stderr. A section that fails raises and the bench exits non-zero. The
interpreted section alone is left out, as ``null`` with a line naming
the path, when its input (the verbatim module ``.frag`` files of the
reference GLava's ``shaders/glava``, read from ``reference/shaders/glava``
in this repository) is not there. The repository does not hold them
yet; :func:`interpreted` times any other module directory.

Timing protocol (``glava_tpu_torch.utils.timing``), in place of the
JAX bench's scan, probe and slope:

* the K inputs of a timed run are made on the device before it, fresh
  for each step (``audio * (1 + 1e-3 k)``, as the JAX scan bodies make
  them), so no step reads what the one before left in the cache;
* every section times the compiled step, what the Engine and the
  fleet run (``jit_step``, ``jit_update``: a CUDA graph replayed a
  call, ``glava_tpu_torch.compiled``), where the JAX bench times a
  jitted function: each call copies its fresh input into the step's
  static buffer, then replays; the first (warm-up) call captures. The
  interpreted section's shader modules run theirs too, a data-dependent
  loop as a while node of the graph;
* the steps run back to back with no probe: ``torch.cuda.synchronize()``
  returns when the card is done;
* fps, windows a second and the ``p50_pcm_to_frame_ms`` keys are host
  clock (:func:`~glava_tpu_torch.utils.timing.host_ms`): what a serving
  loop of compiled steps gets, each call's input copy and replay
  included. The JAX bench ran K steps in one dispatch and took the
  slope, so its numbers leave a dispatch a step out; the two are not
  the same measurement;
* ``device_step_ms`` and ``device_p50_pcm_to_frame_ms`` are the card's
  own busy time from torch.profiler
  (:func:`~glava_tpu_torch.utils.timing.device_ms`), what the JAX
  bench's "device-side" keys meant. On the CPU they are ``null``: a CPU
  run measures no device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from dataclasses import replace
from itertools import count
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from glava_tpu_torch.config import loader
from glava_tpu_torch.device import resolve
from glava_tpu_torch.models import mel as mel_mod
from glava_tpu_torch.parallel.batch import (
    BatchedRenderer, MixedBatchedRenderer, example_batch,
)
from glava_tpu_torch.pipeline import AudioPipeline, UniformSpec
from glava_tpu_torch.renderer import Renderer
from glava_tpu_torch.utils.timing import (
    FP64_FLOPS, HBM_BYTES_PER_S, device_ms, host_ms, update_bytes,
)

SECTIONS = ("windows", "roofline", "bars", "modules", "fleet", "interpreted",
            "bufsize", "saturated", "device_p50", "logmel", "single_dispatch")
# the reference GLava's verbatim module shaders (its shaders/glava), read
# from inside this repository only; not committed yet
REFERENCE_SHADERS = (Path(__file__).resolve().parent.parent
                     / "reference" / "shaders" / "glava")
INTERPRETED = (("bars", ""), ("radial", ""), ("graph", ""),
               ("graph_aa", "#define ANTI_ALIAS 1\n"), ("wave", ""),
               ("circle", ""))
# the keys of the line's "extra" when every section runs
EXTRA_KEYS = ("streams", "bufsize", "fused_kernel", "roofline",
              "bars_fps_per_stream_512x256", "total_fps_64streams",
              "device_step_ms", "radial_1080p_fps", "circle_1080p_fps",
              "graph_1080p_fps", "wave_1080p_fps", "heterogeneous_fleet_64",
              "interpreted_verbatim_1080p_fps", "bufsize_scaling", "saturated",
              "device_p50_pcm_to_frame_ms", "logmel_frames_per_s",
              "p50_pcm_to_frame_ms_single_dispatch")
FLEET_MODULES = ("bars", "radial", "wave", "circle")
CHAIN = ("window", "fft", "gravity", "avg")
PEAK_NAME = "H100 SXM float64 outside the tensor cores (data sheet)"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit_w(smi_csv: str, uuid: str) -> float:
    """The power limit in watts of the card ``uuid`` in the output of
    ``nvidia-smi --query-gpu=uuid,name,power.limit --format=csv,noheader``
    (rows ``GPU-<uuid>, <name>, <limit> W``). Matched by UUID, since
    nvidia-smi lists every card of the machine while torch numbers only
    the visible ones."""
    for row in smi_csv.strip().splitlines():
        cells = [c.strip() for c in row.split(",")]
        if cells[0].removeprefix("GPU-") == uuid.removeprefix("GPU-"):
            return float(cells[-1].split()[0])
    raise RuntimeError(f"nvidia-smi lists no card of UUID {uuid}:\n{smi_csv}")


def card(device) -> tuple[str, float | None]:
    """The device's name and, for a card, its power limit in watts
    (nvidia-smi's ``power.limit`` of the card of the device's UUID)."""
    dev = resolve(device)
    if dev.type == "cpu":
        return "cpu", None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    return torch.cuda.get_device_name(index), power_limit_w(smi, uuid)


def _load(module: str, screen, requests=(), user_dir=None, system_dir=None):
    return loader.load(
        cli_requests=(f"setgeometry 0 0 {screen[0]} {screen[1]}",
                      "setprintframes false") + tuple(requests),
        force_module=module, user_dir=user_dir,
        system_dir=system_dir or loader.SYSTEM_SHADER_DIR)


def _gravity(cfg) -> float:
    return float(np.float32(cfg.gravity_step / cfg.nominal_ups))


def _fresh(audio: torch.Tensor, k: int) -> list[torch.Tensor]:
    """``k`` inputs on ``audio``'s device, ``audio * (1 + 1e-3 i)``."""
    return [audio * (1.0 + 1e-3 * i) for i in range(k)]


def _example_audio(cfg, dev) -> torch.Tensor:
    """``example_batch``'s (2, bufsize) tones of one stream for ``cfg``."""
    return example_batch(SimpleNamespace(n_streams=1, cfg=cfg,
                                         device=dev))["audio"][0]


def _split(m: int) -> tuple[int, int]:
    """The JAX packed FFT's m = m1 * m2 factorization (both powers of
    two, m1 >= m2; ``glava_tpu/ops/fft.py:72``)."""
    k = m.bit_length() - 1
    m2 = 1 << (k // 2)
    return m // m2, m2


def flops_per_window(pipe: AudioPipeline) -> int:
    """Algorithmic FLOPs of ONE stream-update (both channels) through the
    shipped chain: window + four-step packed FFT + log-mag/boost +
    gravity + age-weighted averaging + presmooth resample matmul, the
    JAX bench's count (``bench.py:39-71``). Matmul FLOPs are 2*M*N*K;
    elementwise ops counted once each."""
    n = pipe.sz
    m = n // 2
    m1, m2 = _split(m) if m > 256 else (m, 1)
    U = 2  # audio_l + audio_r
    fft = 8 * m * (m1 + m2) + 6 * m if m2 > 1 else 8 * m * m1
    window = n
    logmag = 4 * n            # abs, log, div, boost-mul (max folded)
    gravity = 3 * n           # max, sub, clip
    F = pipe.cfg.avg_frames
    avg = 2 * F * n + n       # weighted ring reduction + clip
    presmooth = 0
    ps = pipe.presmooth
    if ps is not None and ps.mode == "average":
        if ps.banded is not None:
            B, R, Kb = ps.banded.blocks.shape
            presmooth = 2 * B * R * Kb  # block-banded einsum work
        else:
            band, P = ps.mat_t.shape
            presmooth = 2 * P * band
    return U * (window + fft + logmag + gravity + avg + presmooth)


def bytes_per_window(pipe: AudioPipeline, streams: int) -> float:
    """Bytes the fused update moves for one stream-update at ``streams``
    streams (2 rows a stream; the window and weights shared)."""
    return update_bytes(pipe.sz, 2 * streams, pipe.cfg.avg_frames) / streams


def _updates_ms(pipe: AudioPipeline, audio: torch.Tensor, gravity_g,
                updates: int, warmup: int = 1) -> float:
    """Host ms per update of every stream's chains by the compiled
    update (``jit_update``), ``updates`` of them back to back on fresh
    inputs, each copied into its static buffers, after ``warmup``
    warm-up calls (the first captures the graph)."""
    S = audio.shape[0]
    feeds = _fresh(audio, updates)
    g = np.asarray(gravity_g, np.float32)
    update = pipe.jit_update()
    chains = pipe.init_state(batch=(S,))

    def step(i):
        nonlocal chains
        a = feeds[i]
        chains, _ = update(chains, a[:, 0], a[:, 1], None, None, g)

    return host_ms(step, updates, pipe.device, warmup)


def _steps_ms(step, state, feeds: list, reps: int = 1, dev="cuda") -> float:
    """Median over ``reps`` readings of the host ms per ``step(state,
    audio)`` call, ``len(feeds)`` of them back to back a reading."""
    holder = [state]

    def one(i):
        holder[0] = step(holder[0], feeds[i])

    return statistics.median(host_ms(one, len(feeds), dev) for _ in range(reps))


def _fleet_steps_ms(br, frames: int, reps: int) -> float:
    """Host ms per compiled step of a (mixed) batched renderer on its
    ``example_batch`` inputs, fresh audio each step."""
    ex = example_batch(br)
    feeds = _fresh(ex["audio"], frames)
    fleet = br.jit_step(quantize=False)

    def step(st, a):
        return fleet(st, a, ex["modified"], ex["time"], ex["interp_mod"],
                     ex["gravity_g"])[0]

    return _steps_ms(step, br.init_state(), feeds, reps, br.device)


# -- sections -----------------------------------------------------------


def windows(device="cuda", streams: int = 64, updates: int = 64,
            screen=(512, 256)):
    """FFT windows a second: ``updates`` spectrum updates of a
    ``streams``-stream bars batch back to back (``bench.py:112-135``).
    Returns the line's keys and the pipeline (for :func:`roofline`)."""
    dev = resolve(device)
    br = BatchedRenderer(_load("bars", screen), n_streams=streams, device=dev)
    pipe = br.renderer.pipeline
    ex = example_batch(br)
    ms = _updates_ms(pipe, ex["audio"], ex["gravity_g"], updates)
    wps = streams / (ms / 1e3)
    log(f"windows: {wps:.1f} windows/s ({streams} streams, bufsize "
        f"{pipe.sz}, route {pipe.route}, {ms:.4f} ms an update)")
    return {"windows_per_s": wps, "streams": streams, "bufsize": br.cfg.bufsize,
            "fused_kernel": pipe.route}, pipe


def windows_spread(device="cuda", lengths=(16, 64, 256, 1024),
                   warmups=(1, 64), readings: int = 5, streams: int = 64,
                   screen=(512, 256)) -> dict:
    """How the windows section's host-clock reading depends on its
    window: ``readings`` readings of windows/s on one batch for each
    warm-up count in ``warmups`` and run length in ``lengths``, as
    ``{min, median, max, max_over_min}``. Not a key of the line."""
    dev = resolve(device)
    br = BatchedRenderer(_load("bars", screen), n_streams=streams, device=dev)
    pipe = br.renderer.pipeline
    ex = example_batch(br)
    out = {}
    for w in warmups:
        for n in lengths:
            vals = sorted(streams * 1e3 / _updates_ms(
                pipe, ex["audio"], ex["gravity_g"], n, w)
                for _ in range(readings))
            out[f"{n} updates after {w} warm-up"] = {
                "min": vals[0], "median": statistics.median(vals),
                "max": vals[-1], "max_over_min": vals[-1] / vals[0]}
    return out


def roofline(pipe: AudioPipeline, windows_per_s: float, streams: int,
             device="cuda", power_limit_w: float | None = None) -> dict:
    """Achieved FLOP/s and bytes/s of the update chain at
    ``windows_per_s`` (``bench.py:137-154``): the JAX bench's algorithmic
    FLOP count against the card's float64 rate (the FFT's type), and the
    fused update's bytes against its memory rate. Shares of a peak only
    on a card; on the CPU they are ``null``."""
    flops = flops_per_window(pipe)
    nbytes = bytes_per_window(pipe, streams)
    achieved = windows_per_s * flops
    rate = windows_per_s * nbytes
    card_run = resolve(device).type == "cuda"
    return {
        "flops_per_window": flops,
        "achieved_gflops_algorithmic": achieved / 1e9,
        "pct_fp64_peak_algorithmic": (100.0 * achieved / FP64_FLOPS
                                      if card_run else None),
        "bytes_per_window": nbytes,
        "achieved_gbytes_per_s": rate / 1e9,
        "pct_hbm_peak": 100.0 * rate / HBM_BYTES_PER_S if card_run else None,
        "peak": {"name": PEAK_NAME, "fp64_flops_per_s": FP64_FLOPS,
                 "hbm_bytes_per_s": HBM_BYTES_PER_S,
                 "power_limit_w": power_limit_w} if card_run else None,
        "note": ("the update is bound by memory and latency, not flops; "
                 "host-clock windows/s, launches included"),
    }


def bars_frames(device="cuda", streams: int = 64, frames: int = 16,
                screen=(512, 256)) -> dict:
    """Frames a second of a ``streams``-stream bars batch, full step
    with the raster, ``frames`` steps back to back (``bench.py:156-185``),
    and the card's time a step (``device_step_ms``) over as many."""
    dev = resolve(device)
    br = BatchedRenderer(_load("bars", screen), n_streams=streams, device=dev)
    ex = example_batch(br)
    feeds = _fresh(ex["audio"], frames)
    state = [br.init_state()]
    fleet = br.jit_step(quantize=False)

    def one(i):
        state[0] = fleet(state[0], feeds[i % frames], ex["modified"],
                         ex["time"], ex["interp_mod"], ex["gravity_g"])[0]

    per = host_ms(one, frames, dev)
    k = count()
    dev_ms = (None if dev.type == "cpu"
              else device_ms(lambda: one(next(k)), frames))
    log(f"bars: {streams} streams {screen[0]}x{screen[1]}: {per:.4f} ms a "
        f"step (host), device {dev_ms} ms")
    return {"bars_fps_per_stream_512x256": 1e3 / per,
            "total_fps_64streams": streams * 1e3 / per,
            "device_step_ms": dev_ms}


def module_fps(module: str, requests=(), device="cuda", screen=(1920, 1080),
               frames: int = 16, builds: int = 3) -> dict:
    """``{min, median, best, builds}`` fps of one stream of ``module``
    over ``builds`` fresh ``Renderer``s, ``frames`` steps each on fresh
    audio (``bench.py:187-270``; the JAX bench reports the spread of
    its builds, so the port does too)."""
    dev = resolve(device)
    vals = []
    for _ in range(builds):
        lc = _load(module, screen, requests)
        r = Renderer(lc, device=dev)
        snap = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (2, lc.cfg.bufsize)).astype(np.float32) * 0.3, device=dev)
        g = _gravity(lc.cfg)
        step = r.jit_step()
        ms = _steps_ms(lambda s, a: step(s, a, True, 0.1, 1.0, g)[0],
                       r.init_state(), _fresh(snap, frames), 1, dev)
        vals.append(1e3 / ms)
    vals.sort()
    log(f"{module} {screen[0]}x{screen[1]}: fps over {builds} builds {vals}")
    return {"min": vals[0], "median": statistics.median(vals),
            "best": vals[-1], "builds": len(vals)}


def modules_1080p(device="cuda", screen=(1920, 1080), frames: int = 16,
                  builds: int = 3) -> dict:
    """radial (at ``setsamplerate 44100``), circle, graph and wave, one
    stream each (``bench.py:264-270``)."""
    kw = dict(device=device, screen=screen, frames=frames, builds=builds)
    return {"radial_1080p_fps": module_fps("radial", ("setsamplerate 44100",),
                                           **kw),
            "circle_1080p_fps": module_fps("circle", **kw),
            "graph_1080p_fps": module_fps("graph", **kw),
            "wave_1080p_fps": module_fps("wave", **kw)}


def _mixed(streams: int, screen, dev) -> MixedBatchedRenderer:
    variants = [_load(m, screen) for m in FLEET_MODULES]
    return MixedBatchedRenderer(variants, [i % len(variants)
                                           for i in range(streams)], device=dev)


def _fleet_line(streams: int, per_ms: float) -> dict:
    return {"fps_per_stream": 1e3 / per_ms, "total_fps": streams * 1e3 / per_ms,
            "p50_pcm_to_frame_ms": per_ms,
            "modules": f"{'/'.join(FLEET_MODULES)} x{streams // 4} each"}


def heterogeneous_fleet(device="cuda", streams: int = 64, frames: int = 8,
                        screen=(512, 256), reps: int = 3) -> dict:
    """A ``streams``-stream fleet of bars, radial, wave and circle in
    turn, one step for all (``bench.py:272-330``); the median of
    ``reps`` readings, as the JAX bench's median of 3 slopes."""
    dev = resolve(device)
    per = _fleet_steps_ms(_mixed(streams, screen, dev), frames, reps)
    log(f"heterogeneous fleet: {streams} streams {per:.4f} ms a step (host)")
    return {"heterogeneous_fleet_64": _fleet_line(streams, per)}


def interpreted(module_dir, name: str | None = None, knobs: str = "",
                device="cuda", screen=(1920, 1080), frames: int = 8,
                builds: int = 3, system_dir=None) -> dict:
    """``{min, median, best, builds}`` fps of a GLSL shader module
    through the interpreter's compiled step: the ``.frag`` files of ``module_dir`` copied
    into a config dir as module ``name`` (the directory's name by
    default), with ``knobs`` as its ``<name>.glsl``, at bufsize 1024
    (``scripts/bench_interpreted.py``)."""
    dev = resolve(device)
    src = Path(module_dir)
    name = name or src.name
    vals = []
    for _ in range(builds):
        with tempfile.TemporaryDirectory() as td:
            tmp = Path(td)
            (tmp / name).mkdir()
            for f in sorted(src.glob("*.frag")):
                (tmp / name / f.name).write_bytes(f.read_bytes())
            if knobs:
                (tmp / f"{name}.glsl").write_text(knobs)
            lc = _load(name, screen, ("setbufsize 1024", "setsamplesize 256"),
                       user_dir=tmp, system_dir=system_dir)
            r = Renderer(lc, device=dev)
        snap = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (2, 1024)).astype(np.float32) * 0.3, device=dev)
        step = r.jit_step()
        ms = _steps_ms(lambda s, a: step(s, a, True, 0.0, 1.0, 0.05)[0],
                       r.init_state(), _fresh(snap, frames), 1, dev)
        vals.append(1e3 / ms)
    vals.sort()
    log(f"interpreted {name} ({src}): fps over {builds} builds {vals}")
    return {"min": vals[0], "median": statistics.median(vals),
            "best": vals[-1], "builds": len(vals)}


def interpreted_verbatim(device="cuda", reference=REFERENCE_SHADERS,
                         **kw) -> dict:
    """The reference's verbatim module shaders at 1080p (``bench.py:
    332-361``): each module whose directory is under ``reference``;
    ``null`` for the whole key, with a line naming the path, when none
    is."""
    reference = Path(reference)
    out = {}
    for key, knobs in INTERPRETED:
        module = "graph" if key == "graph_aa" else key
        src = reference / module
        if not src.is_dir():
            log(f"interpreted {key}: no verbatim shader directory {src}; "
                "not measured")
            continue
        out[key] = interpreted(src, module, knobs, device=device,
                               system_dir=reference, **kw)
    return {"interpreted_verbatim_1080p_fps": out or None}


def _stereo_pipe(cfg, bufsize: int, dev) -> AudioPipeline:
    return AudioPipeline(replace(cfg, bufsize=bufsize),
                         [UniformSpec("audio_l", "audio_l", CHAIN),
                          UniformSpec("audio_r", "audio_r", CHAIN)], device=dev)


def _noise(streams: int, bufsize: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((streams, 2, bufsize))
                           .astype(np.float32) * 0.3, device=dev)


def bufsize_scaling(device="cuda", bufsizes=(8192, 16384), streams: int = 64,
                    updates: int = 16, screen=(512, 256)) -> dict:
    """The stereo update at large bufsizes, ``streams`` streams
    (``bench.py:363-419``; the port's presmooth goes banded there too)."""
    dev = resolve(device)
    cfg = _load("bars", screen).cfg
    out = {}
    for bs in bufsizes:
        pipe = _stereo_pipe(cfg, bs, dev)
        us = _updates_ms(pipe, _noise(streams, bs, 2, dev),
                         np.float32(_gravity(pipe.cfg)), updates) * 1e3
        out[str(bs)] = {"us_per_update_64streams": us,
                        "windows_per_s": streams * 1e6 / us}
        log(f"bufsize {bs}: {us:.2f} us an update of {streams} streams "
            f"(route {pipe.route})")
    return {"bufsize_scaling": out}


def saturated(device="cuda", streams: int = 256, bufsize: int = 1024,
              updates: int = 16, fleet_streams: int = 256,
              fleet_frames: int = 4, screen=(512, 256), reps: int = 3) -> dict:
    """The scale-out points (``bench.py:421-527``): the stereo update of
    ``streams`` streams at ``bufsize``, and a ``fleet_streams``-stream
    mixed fleet step (median of ``reps`` readings)."""
    dev = resolve(device)
    cfg = _load("bars", screen).cfg
    pipe = _stereo_pipe(cfg, bufsize, dev)
    dt = _updates_ms(pipe, _noise(streams, bufsize, 5, dev),
                     np.float32(_gravity(pipe.cfg)), updates)
    per = _fleet_steps_ms(_mixed(fleet_streams, screen, dev), fleet_frames,
                          reps)
    log(f"saturated: update {dt * 1e3:.2f} us ({streams} streams, bufsize "
        f"{bufsize}), fleet {per:.4f} ms ({fleet_streams} streams)")
    return {"saturated": {
        "update_256streams_bufsize1024": {
            "windows_per_s": streams / (dt / 1e3), "us_per_update": dt * 1e3},
        "fleet_256streams_512x256": _fleet_line(fleet_streams, per),
    }}


def device_p50(device="cuda", steps: int = 32, readings: int = 7,
               screen=(512, 256)) -> dict:
    """Median of ``readings`` profiler readings of the card's time per
    single-stream bars step, ``steps`` steps each on fresh audio
    (``bench.py:529-567``); ``null`` on the CPU."""
    dev = resolve(device)
    if dev.type == "cpu":
        log("device p50: a cpu run measures no device; not measured")
        return {"device_p50_pcm_to_frame_ms": None}
    lc = _load("bars", screen)
    r = Renderer(lc, device=dev)
    feeds = _fresh(_example_audio(lc.cfg, dev), steps)
    g = _gravity(lc.cfg)
    state = [r.init_state()]
    k = count()
    step = r.jit_step()

    def one():
        state[0] = step(state[0], feeds[next(k) % steps], True, 0.0, 1.0,
                        g)[0]

    samples = [device_ms(one, steps) for _ in range(readings)]
    log(f"device p50: readings {samples} ms")
    return {"device_p50_pcm_to_frame_ms": float(np.median(samples))}


def logmel(device="cuda", frames: int = 1024, n_fft: int = 512,
           passes: int = 16) -> dict:
    """Whisper-style log-mel features a second: ``passes`` calls on
    ``frames`` fresh frames of ``n_fft`` (``bench.py:569-604``)."""
    dev = resolve(device)
    rng = np.random.default_rng(11)
    frm = torch.as_tensor(rng.standard_normal((frames, n_fft))
                          .astype(np.float32) * 0.2, device=dev)
    feeds = _fresh(frm, passes)
    ms = host_ms(lambda i: mel_mod.log_mel(feeds[i], device=dev), passes, dev)
    log(f"log-mel: {ms:.4f} ms for {frames} frames")
    return {"logmel_frames_per_s": frames / (ms / 1e3)}


def single_dispatch(device="cuda", samples: int = 30,
                    screen=(512, 256)) -> dict:
    """p50 of the synchronous PCM-to-pixels round trip of one bars
    stream: host snapshot -> the compiled step (its one host-to-device
    copy, a replay) -> pageable ``.cpu()`` (``bench.py:606-628``)."""
    import time

    dev = resolve(device)
    lc = _load("bars", screen)
    r = Renderer(lc, device=dev)
    snap = _example_audio(lc.cfg, "cpu").numpy()
    g = _gravity(lc.cfg)
    step = r.jit_step()
    st, f = step(r.init_state(), snap, True, 0.0, 1.0, g)
    f.cpu()
    lats = []
    for _ in range(samples):
        t0 = time.perf_counter()
        st, f = step(st, snap, True, 0.0, 1.0, g)
        f.cpu()
        lats.append(time.perf_counter() - t0)
    p50 = float(np.median(lats) * 1e3)
    log(f"single dispatch: p50 {p50:.4f} ms over {samples}")
    return {"p50_pcm_to_frame_ms_single_dispatch": p50}


# -- the line -----------------------------------------------------------


def run(sections=SECTIONS, device="cuda") -> dict:
    """Run ``sections`` (names from :data:`SECTIONS`; ``roofline`` needs
    the windows section's reading and runs it) and return the line."""
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown bench sections {sorted(unknown)}; "
                         f"choose from {SECTIONS}")
    dev = resolve(device)
    name, power = card(dev)
    log(f"bench on {name}" + (f", power limit {power} W" if power else ""))
    extra, value = {}, None
    if "windows" in sections or "roofline" in sections:
        w, pipe = windows(dev)
        value = w.pop("windows_per_s")
        extra.update(w)
        if "roofline" in sections:
            extra["roofline"] = roofline(pipe, value, w["streams"], dev, power)
    steps = {"bars": bars_frames, "modules": modules_1080p,
             "fleet": heterogeneous_fleet, "interpreted": interpreted_verbatim,
             "bufsize": bufsize_scaling, "saturated": saturated,
             "device_p50": device_p50, "logmel": logmel,
             "single_dispatch": single_dispatch}
    for s in SECTIONS:
        if s in steps and s in sections:
            extra.update(steps[s](device=dev))
    return {
        "metric": "fft_windows_per_sec_per_chip",
        "value": value,
        "unit": "windows/s",
        "vs_baseline": value / 10_000.0 if value is not None else None,
        "device": name,
        "power_limit_w": power,
        "extra": extra,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m glava_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("sections", nargs="*",
                    help=f"sections to run (default all): {' '.join(SECTIONS)}")
    args = ap.parse_args(argv)
    line = run(tuple(args.sections) or SECTIONS, args.device)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

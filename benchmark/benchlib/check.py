"""Whether the frames the window handed to the sinks are right.

The run records, for every frame the loop made (warm-up and window),
each stream's snapshot (the number of hops in the ring, found from the
snapshot's newest samples), its ``modified`` flag, the frame's times,
its gravity step and the loop's measured update rate, and keeps copies
of frames sampled at seeded times of the window. After the window the
plain reference (``reference/``) works out each frame's gravity step
from the flags and times (``reference.gravity``), replays every update
from the same PCM and renders the sampled frames. Compared, each with
its limit (``LIMITS``):

* ``spec_err``: the largest gap between the program's spectrum state
  after its last frame (gravity and average, every row it holds) and
  the reference's;
* ``px_off``: pixels of the sampled frames with a channel more than 2
  LSB from the reference's frame, among the stable pixels: those that
  the reference draws alike from its textures shifted by ``+-BAND``
  (``BAND_SCALE`` times the spectrum's limit). A pixel at a bar's or
  a ring's edge flips on rounding alone (a texture off by 1e-7 moves a
  bar by 3e-5 px); every other pixel must come out as the reference
  draws it, so the comparison is exact and its limit 0;
* ``gravity_off``: frames (stream by stream) whose gravity step is not
  the reference's (relative gap over ``GRAVITY_RTOL``), and ticks of
  the loop's rate that were due and did not come;
* ``unresolved``: snapshots that match no count of pushes of the input;
* ``unpaired``: frames whose snapshots, steps and hand-offs do not pair
  one to one, stream by stream;
* ``missing``: sampled frames that never reached their sink.

The control (``control=True``) puts the reference computed one step of
precision lower (``reference.dsp``) in the program's place and reads
the same two numbers against the reference.

The reference holds one row for each row of the program's state (the
record's row map: every fft uniform of every stream, in the program's
order), each fed from the PCM channel its uniform names
(``CHANNELS``); a sampled frame's raster gets its textures by the names
its module binds. A row that the reference cannot replay (another
source, another chain than ``CHAIN``) stops the check with an error
naming it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from benchlib import pcm as pcm_mod

# limits, set from the readings in PERF.md ("How correct is decided")
LIMITS = {"spec_err": 2.5e-6, "px_off": 0, "gravity_off": 0,
          "unresolved": 0, "unpaired": 0, "missing": 0}
# the float32 steps of the program and of the reference agree to rounding
GRAVITY_RTOL = 1e-6
# the texture shift that marks a pixel unstable, over the spectrum's limit
BAND_SCALE = 4.0
# the PCM channel of each source a row may have, and the one chain that
# reference.dsp replays (then the configuration's smooth pass)
CHANNELS = {"audio_l": 0, "audio_r": 1}
CHAIN = ("window", "fft", "gravity", "avg")


@dataclass
class RunRecord:
    """What the check reads of one run."""

    modules: list                 # module name of each stream
    pipe: dict                    # name -> (S, 4) values, or {}
    pushes: np.ndarray            # (K, S) hops in the ring at each snapshot
    mods: np.ndarray              # (K, S) modified flags
    gravity: np.ndarray           # (K, S) the program's float32 gravity steps
    times: np.ndarray             # (K, 2) each step's start and end, host clock
    ticks: np.ndarray             # (K,) the loop's rate is a new one at frame k
    ups: np.ndarray               # (K, S) the loop's measured rate at frame k
    runs: list                    # (first frame, host time of the call) a run
    samples: list                 # (stream, frame index, (H, W, 4) uint8)
    state: dict                   # benchlib.system.program_rows
    counts: dict = field(default_factory=dict)   # unresolved, unpaired, missing


def resolve(pcm: np.ndarray, s: int, c0: np.ndarray, c1: np.ndarray,
            fp: np.ndarray, hop: int) -> np.ndarray:
    """The hop count of each snapshot of stream ``s``: the one of ``c0 ..
    c1 + 1`` (pushes counted before the snapshot began and after it
    ended; a push that has written the ring may not be counted yet)
    whose newest samples equal the snapshot's ``fp`` (K, 2); -1 where
    none does."""
    out = np.full(len(c0), -1, np.int64)
    for d in range(int((c1 - c0).max(initial=0)) + 1, -1, -1):
        n = c0 + d
        ok = n <= c1 + 1
        hit = ok & (pcm_mod.last_samples(pcm, s, n, hop) == fp).all(axis=1)
        out[hit] = n[hit]
    return out


def _windows(pcm_dev: torch.Tensor, streams: np.ndarray, pushes: np.ndarray,
             hop: int, n: int) -> torch.Tensor:
    """(len(streams), 2, n) ring snapshots from the PCM on the device."""
    dev = pcm_dev.device
    end = torch.as_tensor(pushes * hop, device=dev)[:, None]
    idx = end - n + torch.arange(n, device=dev)[None, :]
    valid = idx >= 0
    idx = torch.remainder(idx, pcm_dev.shape[-1])
    s = torch.as_tensor(streams, device=dev)[:, None, None]
    c = torch.arange(2, device=dev)[None, :, None]
    return pcm_dev[s, c, idx[:, None, :]] * valid[:, None, :]


def _px_off(got: np.ndarray, want: np.ndarray, stable: np.ndarray) -> int:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(((diff > 2).any(axis=-1) & stable).sum())


def replayed_rows(rows: list) -> tuple:
    """(stream, PCM channel) of each row of the row map, as (R,) int64
    arrays; raises for a row the reference does not replay."""
    for r in rows:
        if r.source not in CHANNELS or tuple(r.chain) != CHAIN:
            raise ValueError(
                f"stream {r.stream}: uniform {r.uniform!r} takes "
                f"{r.source!r} through {tuple(r.chain)}; the check replays "
                f"only {sorted(CHANNELS)} through {CHAIN}")
    return (np.array([r.stream for r in rows], np.int64),
            np.array([CHANNELS[r.source] for r in rows], np.int64))


def judge(rec: RunRecord, pcm: np.ndarray, config: dict, device,
          control: bool = False) -> dict:
    """The readings of the program (``"program"``) and, with
    ``control``, of the control (``"control"``), each a dict of the
    numbers in ``LIMITS``."""
    from reference import dsp, gravity, module

    dsp_cfg = config["dsp"]
    n, hop = int(dsp_cfg["bufsize"]), int(dsp_cfg["samplesize"]) // 4
    w, h = config["geometry"]
    K, S = rec.pushes.shape
    row_stream, row_chan = replayed_rows(rec.state["rows"])
    R = len(row_stream)
    if any(len(rec.state[name]) != R for name in ("gravity", "avg")):
        raise ValueError(f"the program's state holds other rows than its "
                         f"row map's {R}")
    dev = torch.device(device)
    pcm_dev = torch.as_tensor(pcm, device=dev)
    ref = dsp.Spectra(R, dsp_cfg, dev)
    low = dsp.Spectra(R, dsp_cfg, dev, low=True) if control else None
    rasters = {m: module(m).Module(config["knobs"][m], w, h, n, dev)
               for m in sorted(set(rec.modules))}
    by_frame: dict = {}
    for i, (s, k, _frame) in enumerate(rec.samples):
        by_frame.setdefault(k, []).append(i)
    key = np.zeros(S, np.int64)          # pushes of each stream's last update
    drawn = [None] * len(rec.samples)    # the reference's sampled frames
    drawn_low = [None] * len(rec.samples)
    stable = [None] * len(rec.samples)
    band = BAND_SCALE * LIMITS["spec_err"]
    g_ref, missed = gravity.steps(rec.runs, rec.times, rec.ticks, rec.mods,
                                  rec.ups, dsp_cfg)
    gravity_off = missed + int((np.abs(rec.gravity.astype(np.float64) - g_ref)
                                > GRAVITY_RTOL * np.abs(g_ref)).sum())
    at = np.full(S, -1, np.int64)        # a stream's place among the updated
    for k in range(K):
        ss = np.nonzero(rec.mods[k])[0]
        key[ss] = rec.pushes[k, ss]
        sel = np.nonzero(rec.mods[k][row_stream])[0]
        if sel.size:
            at[ss] = np.arange(ss.size)
            win = _windows(pcm_dev, ss, key[ss], hop, n)[
                torch.as_tensor(at[row_stream[sel]], device=dev),
                torch.as_tensor(row_chan[sel], device=dev)]
            rows = torch.as_tensor(sel, device=dev)
            g = torch.as_tensor(g_ref[k, row_stream[sel]], device=dev)
            for sp in (ref, low) if low is not None else (ref,):
                sp.update(rows, win, g)
        for i in by_frame.get(k, ()):
            s = rec.samples[i][0]
            feed = _windows(pcm_dev, np.array([s]), key[[s]], hop, n)
            mine = np.nonzero(row_stream == s)[0]
            rows = torch.as_tensor(mine, device=dev)
            place = {int(r): j for j, r in enumerate(mine)}
            names = {name: place[r]
                     for name, r in rec.state["binds"][s].items()}
            pipe = {name: v[[s]] for name, v in rec.pipe.items()}
            raster = rasters[rec.modules[s]]

            def draw(tex):
                return raster.render({name: tex[j:j + 1]
                                      for name, j in names.items()},
                                     feed, pipe)[0]

            tex = ref.textures(rows)
            frame = draw(tex)
            drawn[i] = frame.cpu().numpy()
            stable[i] = torch.stack([
                (draw(torch.clamp(tex + b, 0.0, 1.0)) == frame).all(dim=-1)
                for b in (band, -band)]).all(dim=0).cpu().numpy()
            if low is not None:
                drawn_low[i] = draw(low.textures(rows)).cpu().numpy()

    def spec_err(state: dict) -> float:
        return max(float((torch.as_tensor(state[name], device=dev).double()
                          - ref.planes(getattr(ref, name))).abs().max())
                   for name in ("grav", "avg"))

    out = {"program": {
        "spec_err": spec_err({"grav": rec.state["gravity"],
                              "avg": rec.state["avg"]}),
        "px_off": sum(_px_off(f, r, st) for (_, _, f), r, st
                      in zip(rec.samples, drawn, stable))}}
    if low is not None:
        out["control"] = {
            "spec_err": spec_err({name: low.planes(getattr(low, name))
                                  for name in ("grav", "avg")}),
            "px_off": sum(_px_off(c, r, st) for c, r, st
                          in zip(drawn_low, drawn, stable))}
    for side in out.values():
        side["gravity_off"] = gravity_off
        side.update({k: int(rec.counts.get(k, 0))
                     for k in ("unresolved", "unpaired", "missing")})
    return out


def verdict(readings: dict) -> bool:
    """Every number within its limit."""
    return all(readings[k] <= lim for k, lim in LIMITS.items())

"""AudioPipeline: PCM windows -> per-uniform spectrum textures.

The device-side "update" half of the reference's frame loop (the
``handle_audio`` closure, glava/render.c:2113-2309). A module's
uniforms come in two kinds:

* **fft uniforms** (any chain holding ``fft``) run the accel path's
  spectrum -> gravity -> history -> average update whatever the rest of
  their chain, as the JAX package does (glava_tpu/pipeline.py:283-334,
  419-439); the texture the rasterizer samples is the age-weighted
  average after the default smooth pass (render.c:2276-2303), a baked
  resample.
  The whole update of all fft uniforms is ONE call of
  ``ops.fused.fused_update`` (or ``chain_update``, see below) over the
  flat row batch ``(B, ...)`` with row order ``s * U + u`` (streams x
  fft uniforms): on CUDA tensors that is the hand-written kernel, on
  CPU tensors its plain torch version. The state layout is the JAX
  package's ``FusedChainState`` (glava_tpu/pipeline.py:72-91).
* **stateless uniforms** (no ``fft``, e.g. wave's ``window, wrange``)
  carry no state: their texture is the frame's feed audio through the
  chain's ``wrange`` and ``smooth`` transforms in order (``window``
  being a no-op without ``fft``, glava_tpu/pipeline.py:440-449);
  ``smooth`` is ``ops.smooth.smooth_transform``, the CUDA kernel on the
  card. A ``smooth`` in an fft chain is ignored, as in the JAX package:
  the whole chain takes the fft update. A module with no fft uniform
  keeps a state of B = 0 rows and launches no update.

The update's route (``AudioPipeline.route``) follows from the
configuration alone:

* ``"kernel"``: the accel path (``setaccelfft true``, the default) at a
  scaled bufsize that is a power of two from 256 to 2^24: 256..65536 on
  the kernel's one-cluster route, above 65536 on its split route (two
  launches through a float64 scratch tensor, ``ops.fused.fft_plan``);
* ``"chain"``: the same function in plain torch on the rows' own device
  (``ops.fused.chain_update``): the accel path at 4..128 and above
  2^24, where the JAX package takes its XLA chain too
  (``_fused_supported``, glava_tpu/pipeline.py:126-137, sets a lower
  limit and no upper one), and the CPU path (``setaccelfft
  false``) at every bufsize, unclamped: the spectrum and the gravity
  store run without the accel path's GL_R16 clamps and the average
  clamps only at the texture (glava_tpu/pipeline.py:310-313). The JAX
  package never takes its Pallas kernel on the CPU path, so no kernel
  is ported for it.

Other bufsizes raise ``ValueError``. Above 2^24 the split plan's
k-point stage no longer fits a CTA, so those sizes take the chain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from glava_tpu_torch import compiled
from glava_tpu_torch.config.state import RenderConfig
from glava_tpu_torch.device import resolve
from glava_tpu_torch.ops import fused, smooth, smoothing, transforms, windows


@dataclass(frozen=True)
class UniformSpec:
    """One audio uniform binding and its transform chain (mirrors
    ``#request uniform`` + ``#request transform`` declarations)."""

    name: str                      # uniform name in the module ("audio_l")
    source: str                    # "audio_l" | "audio_r"
    transforms: tuple[str, ...]    # declared chain, reference names


class FusedChainState(NamedTuple):
    """Carry of the fused update, flat over rows ``s * U + u``.

    ``gravity`` and ``history`` are updated IN PLACE by every
    :meth:`AudioPipeline.advance`; ``avg`` caches the averaged spectrum
    that carried frames reuse, like the reference reuses the last
    average texture (render.c:2268-2272)."""

    gravity: torch.Tensor   # (B, 2, m)
    history: torch.Tensor   # (B, F, 2, m) rolling ring
    avg: torch.Tensor       # (B, 2, m) last averaged spectrum
    count: torch.Tensor     # (B,) int32 per-row update counter, mod F
    #                         (the next ring slot to write)


KNOWN_TRANSFORMS = {"window", "fft", "wrange", "avg", "gravity", "smooth"}


def has_fft(chain) -> bool:
    return "fft" in chain


class AudioPipeline:
    """The fused spectrum update for a set of uniform chains."""

    def __init__(self, cfg: RenderConfig, uniforms: list[UniformSpec],
                 device="cuda"):
        self.cfg = cfg
        self.uniforms = list(uniforms)
        self.device = resolve(device)
        self.sz = cfg.scaled_bufsize
        for u in self.uniforms:
            unknown = set(u.transforms) - KNOWN_TRANSFORMS
            if unknown:
                raise ValueError(
                    f"transform function does not exist: {sorted(unknown)!r}")
        self.fft_uniforms = [u for u in self.uniforms if has_fft(u.transforms)]
        # "kernel" or "chain" (None: no fft uniform, no update)
        if not self.fft_uniforms:
            self.route = None
        elif cfg.accel_fft:
            self.route = fused.update_route(self.sz)
        else:
            fused.check_length(self.sz)
            self.route = "chain"
        dev = self.device
        self.avg_weights = windows.avg_weights(
            cfg.avg_frames, cfg.avg_window, cfg.accel_fft)
        self.age_weights = torch.as_tensor(
            fused.age_weights(self.avg_weights), device=dev)
        self.window = torch.as_tensor(windows.pcm_window(self.sz), device=dev)
        self.presmooth = (
            smoothing.presmooth_op(
                self.sz, smoothing.SmoothParams(factor=cfg.smooth_factor)
            ).on(dev)
            if cfg.smooth_pass and self.fft_uniforms else None
        )

    # -- state ----------------------------------------------------------

    def init_state(self, batch: tuple[int, ...] = ()) -> FusedChainState:
        B = len(self.fft_uniforms) * int(np.prod(batch, dtype=np.int64))
        m = self.sz // 2
        F = self.cfg.avg_frames
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=self.device)
        return FusedChainState(
            gravity=z(B, 2, m), history=z(B, F, 2, m), avg=z(B, 2, m),
            count=torch.zeros(B, dtype=torch.int32, device=self.device),
        )

    def _params(self, fft_scale, fft_cutoff, gravity_g) -> tuple:
        """The three update parameters, the configuration's for None."""
        cfg = self.cfg
        return (
            cfg.fft_scale if fft_scale is None else fft_scale,
            cfg.fft_cutoff if fft_cutoff is None else fft_cutoff,
            cfg.gravity_step / cfg.nominal_ups if gravity_g is None else gravity_g,
        )

    def _row_params(self, B: int, fft_scale, fft_cutoff, gravity_g):
        """Scalar or per-stream (S,) parameters -> (3, B) float32 rows
        (per-stream values tile over the U uniforms of each stream)."""
        vals = self._params(fft_scale, fft_cutoff, gravity_g)
        if all(np.ndim(v) == 0 and not isinstance(v, torch.Tensor)
               for v in vals):
            # host scalars: one host-to-device copy for all three rows
            return torch.as_tensor(self.host_rows(B, *vals), device=self.device)
        U = len(self.fft_uniforms)
        rows = []
        for v in vals:
            t = torch.as_tensor(v, dtype=torch.float32, device=self.device)
            if t.ndim:
                t = t.repeat_interleave(U)
            rows.append(t.expand(B) if t.ndim == 0 else t)
        return torch.stack(rows).contiguous()

    def host_rows(self, B: int, fft_scale=None, fft_cutoff=None,
                  gravity_g=None) -> np.ndarray:
        """The (3, B) float32 parameter rows of host values (scalars or
        per-stream (S,) arrays; None takes the configuration's) on the
        host: what a compiled step writes into its staging buffer, to
        reach its static rows in the frame's one host-to-device copy."""
        U = len(self.fft_uniforms)
        out = np.empty((3, B), np.float32)
        for r, v in enumerate(self._params(fft_scale, fft_cutoff,
                                           gravity_g)):
            v = np.asarray(v, np.float32)
            out[r] = np.repeat(v, U) if v.ndim else v
        return out

    # -- state transition --------------------------------------------------

    def advance(self, state: FusedChainState, audio_l: torch.Tensor,
                audio_r: torch.Tensor, *, fft_scale=None, fft_cutoff=None,
                gravity_g=None, rows: torch.Tensor | None = None,
                ) -> FusedChainState:
        """Apply one audio update to every row. ``audio_l``/``audio_r``
        are (*batch, bufsize). Every tensor of ``state`` (gravity,
        history, the average and the counter) is updated in place and
        is the result's, so a captured step keeps its state at the
        addresses of the capture. ``rows``, when given, is the (3, B)
        parameter buffer on the device (a compiled step's static input,
        :meth:`host_rows`) and the three parameters are not read. A
        module with no fft uniform has nothing to update."""
        cfg = self.cfg
        if not self.fft_uniforms:
            return state
        sources = {
            "audio_l": transforms.decimate(audio_l, cfg.bufscale),
            "audio_r": transforms.decimate(audio_r, cfg.bufscale),
        }
        pcm = torch.stack([sources[u.source] for u in self.fft_uniforms],
                          dim=-2)
        pcm = pcm.reshape(-1, self.sz).to(torch.float32).contiguous()
        B = pcm.shape[0]
        if rows is None:
            rows = self._row_params(B, fft_scale, fft_cutoff, gravity_g)
        scale, cutoff, g = rows
        if self.route == "kernel":
            fused.fused_update(
                pcm, state.gravity, state.history, state.count,
                scale, cutoff, g, self.window, self.age_weights,
                avg=state.avg)
        else:
            fused.chain_update(
                pcm, state.gravity, state.history, state.count,
                scale, cutoff, g, self.window, self.age_weights,
                clamp=cfg.accel_fft, avg=state.avg)
        # store mod F: only slot/age math ever consumes count
        state.count.add_(1).remainder_(cfg.avg_frames)
        return state

    # -- textures ---------------------------------------------------------

    def textures_from(self, state: FusedChainState, audio_l: torch.Tensor,
                      audio_r: torch.Tensor) -> dict[str, torch.Tensor]:
        """Every uniform's (*batch, sz) texture: fft uniforms from the
        (possibly carried) averaged spectrum, stateless ones from the
        feed audio ``audio_l``/``audio_r`` (*batch, bufsize). Audio
        textures are GL_R16 unsigned normalized (render.c:512-523):
        values clamp to [0, 1]."""
        batch = tuple(audio_l.shape[:-1])
        U = len(self.fft_uniforms)
        m = self.sz // 2
        avg = state.avg.reshape(*batch, U, 2, m)
        row = {u.name: i for i, u in enumerate(self.fft_uniforms)}
        textures = {}
        for u in self.uniforms:
            if u.name not in row:
                src = audio_l if u.source == "audio_l" else audio_r
                buf = transforms.decimate(
                    torch.as_tensor(src, dtype=torch.float32,
                                    device=self.device), self.cfg.bufscale)
                for t in u.transforms:
                    if t == "wrange":
                        buf = transforms.wrange(buf)
                    elif t == "smooth":
                        buf = smooth.smooth_transform(
                            buf, self.cfg.smooth_ratio,
                            self.cfg.smooth_distance)
                textures[u.name] = torch.clamp(buf, 0.0, 1.0)
                continue
            i = row[u.name]
            re, im = avg[..., i, 0, :], avg[..., i, 1, :]
            if self.presmooth is not None:
                # resample straight off the complex planes
                tex = self.presmooth.apply_planes(re, im)
            else:
                tex = torch.stack([re, im], dim=-1).reshape(*re.shape[:-1], self.sz)
            textures[u.name] = torch.clamp(tex, 0.0, 1.0)
        return textures

    # -- per-stream update gating --------------------------------------------

    def select_updated(self, new_state: FusedChainState,
                       old_state: FusedChainState,
                       modified: torch.Tensor) -> FusedChainState:
        """Keep ``new_state`` rows where ``modified`` (S,) is true and
        ``old_state`` rows elsewhere: the vectorized form of the
        reference's only-transform-on-new-audio rule (render.c:2122).
        :meth:`advance` writes gravity and history in place, so
        ``old_state`` must hold copies taken before the advance."""
        mask = modified.to(self.device).repeat_interleave(len(self.fft_uniforms))

        def sel(n, o):
            return torch.where(mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)

        return FusedChainState(*(sel(n, o) for n, o in zip(new_state, old_state)))

    # -- combined update (advance + textures) -------------------------------

    def update(self, state: FusedChainState, audio_l: torch.Tensor,
               audio_r: torch.Tensor, *, fft_scale=None, fft_cutoff=None,
               gravity_g=None):
        new_state = self.advance(state, audio_l, audio_r, fft_scale=fft_scale,
                                 fft_cutoff=fft_cutoff, gravity_g=gravity_g)
        return new_state, self.textures_from(new_state, audio_l, audio_r)

    # -- convenience: the compiled update ---------------------------------

    def jit_update(self):
        """The compiled update, the counterpart of the JAX package's
        ``jit_update`` (``jax.jit(step, donate_argnums=(0,))``):
        ``step(state, audio_l, audio_r, fft_scale, fft_cutoff, gravity_g)
        -> (state, textures)``. The state is donated: the step owns it,
        and the state it returns is the step's static buffers
        (:class:`CompiledUpdate`); on a card the update is captured into
        a CUDA graph once and replayed a call."""
        return CompiledUpdate(self)


class CompiledUpdate:
    """:meth:`AudioPipeline.jit_update`'s callable. Per call the two
    (*batch, bufsize) channels and the (3, B) parameter rows (from
    ``fft_scale``, ``fft_cutoff`` and ``gravity_g``: numbers, per-stream
    (S,) arrays or tensors, read on the host, or None for the
    configuration's) go into static inputs, the host values in one
    host-to-device copy (``compiled.Step``); the update and the
    textures run on the donated state in place. The textures are the
    step's static outputs, overwritten by the next call."""

    def __init__(self, pipeline: AudioPipeline):
        self.pipeline = pipeline
        self.step = compiled.Step(
            pipeline.device,
            {"audio_l": torch.float32, "audio_r": torch.float32,
             "rows": torch.float32})

    def __call__(self, state, audio_l, audio_r, fft_scale=None,
                 fft_cutoff=None, gravity_g=None):
        st = self.step.donate(state)
        rows = self.pipeline.host_rows(
            st.count.shape[0], *(v.cpu().numpy() if isinstance(v, torch.Tensor)
                                 else v for v in (fft_scale, fft_cutoff,
                                                  gravity_g)))
        self.step.load(audio_l=audio_l, audio_r=audio_r, rows=rows)
        return st, self.step.run(None, self._body)

    def _body(self, _branch):
        p, st, inp = self.pipeline, self.step.state, self.step.inputs
        p.advance(st, inp["audio_l"], inp["audio_r"], rows=inp["rows"])
        return p.textures_from(st, inp["audio_l"], inp["audio_r"])


def clone_state(state: FusedChainState) -> FusedChainState:
    """A copy of ``state`` that a later in-place advance leaves intact
    (the ``old_state`` of :meth:`AudioPipeline.select_updated`)."""
    return FusedChainState(*(t.clone() for t in state))


def frame_windows(pcm: np.ndarray, bufsize: int, hop: int) -> np.ndarray:
    """Host-side helper: slice a PCM track into overlapping ring snapshots.

    Emulates the capture ring (fifo.c:91-110): window ``k`` holds the
    ``bufsize`` samples ending at ``(k + 1) * hop``, zero-padded on the
    left before enough history accumulates. Returns (n_windows, bufsize).
    """
    n = len(pcm)
    count = max(n // hop, 0)
    out = np.zeros((count, bufsize), dtype=np.float32)
    for k in range(count):
        end = (k + 1) * hop
        start = max(end - bufsize, 0)
        seg = pcm[start:end]
        out[k, bufsize - len(seg):] = seg
    return out

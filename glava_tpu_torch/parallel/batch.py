"""BatchedRenderer: many independent audio streams in one step.

The port of ``glava_tpu/parallel/batch.py`` for one card (BASELINE.json
config 4: 64 concurrent streams with per-stream parameters). Where the
JAX package ``vmap``s the single-stream raster over streams, the port
writes the stream axis out:

* the spectrum update of every stream is ONE fused call over B = S * U
  rows (rows ``s * U + u``), the CUDA kernel on the card;
* a batched module (every native module: bars, radial, circle, wave,
  graph, test; ``ModuleBuild.batched``) rasterizes every stream in one
  call of its pass chain, the knobs it evaluates inside a pass taking
  each stream's pipe values;
* a user shader module renders one stream at a time inside the same
  step, each stream's pipe row (device tensors) loaded into the
  module's env before its render: the written-out form of the JAX
  ``vmap`` (glava_tpu/parallel/batch.py:98-116).

Per-stream update gating follows the JAX step: every row advances and
:meth:`AudioPipeline.select_updated` keeps the carried rows of the
streams with no new audio. The advance writes the state in place, so
the carried rows are copied first, and only when some stream is not
modified. On the CPU path with ``setinterpolate`` on, the feed blends
each stream's two newest keyframes by its ``interp_mod`` before the
gated advance (glava_tpu/parallel/batch.py:76-88). Per-stream scalars
(``time``, ``interp_mod``, ``gravity_g``) and pipe values (name ->
(S, ...)) have a leading stream axis; the eager step reads the
``modified`` mask on the host.

``jit_step`` of each renderer is the compiled fleet step, the
counterpart of the JAX fleet's ``jax.jit(step, donate_argnums=(0,))``
(glava_tpu/runtime/fleet.py:185-191): captured into a CUDA graph and
replayed a frame (``compiled.py``). Inside it every stream advances and
the update is selected on the device by the mask, as the JAX step
computes it; the pipe rows are static inputs, so one graph serves every
value.

:class:`ShardedRenderer` is the counterpart of the JAX
``BatchedRenderer.sharded_step``/``shard_state`` and
``MixedBatchedRenderer.shard_state`` (glava_tpu/parallel/batch.py:127-163,
306-310): one renderer a device of a ``parallel.mesh.Mesh``, over its
block of streams and its band of the frame's rows. Its state stays per
device and is never gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from glava_tpu_torch import compiled
from glava_tpu_torch.config.loader import LoadedConfig
from glava_tpu_torch.ops import transforms
from glava_tpu_torch.pipeline import (
    AudioPipeline, FusedChainState, UniformSpec, clone_state,
)
from glava_tpu_torch.render.base import device_plane, interleave, interleave_u8
from glava_tpu_torch.renderer import Renderer, RenderState, load_pipe_values
from glava_tpu_torch.utils import profiling


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _advance(pipeline: AudioPipeline, state: RenderState, audio, modified,
             interp_mod, gravity_g):
    """The keyframe push and the gated spectrum update of every stream
    -> (chains, key_start, key_end, feed)."""
    dev = pipeline.device
    cfg = pipeline.cfg
    audio = torch.as_tensor(audio, dtype=torch.float32, device=dev)
    mod = _host(modified).astype(bool).reshape(-1)
    m = torch.as_tensor(mod, device=dev)
    m3 = m[:, None, None]
    # keyframe push on update (render.c:2348-2353)
    key_start = torch.where(m3, state.key_end, state.key_start)
    key_end = torch.where(m3, audio, state.key_end)
    if cfg.interpolate and not cfg.accel_fft:
        # CPU-path interpolation (render.c:1792-1809); the accel path
        # feeds the newest keyframe (render.c:2161-2173)
        feed = transforms.interpolate(key_start, key_end,
                                      _host(interp_mod).reshape(-1))
    else:
        feed = key_end
    carried = None if mod.all() else clone_state(state.chains)
    chains = pipeline.advance(state.chains, feed[:, 0, :], feed[:, 1, :],
                              gravity_g=gravity_g)
    if carried is not None:
        chains = pipeline.select_updated(chains, carried, m)
    return chains, key_start, key_end, feed


def _advance_static(pipeline: AudioPipeline, st: RenderState, inp: dict):
    """:func:`_advance` on a compiled step's static state and inputs
    (``audio``, ``modified``, ``interp``, ``rows``), in place: every
    stream advances and the mask selects on the device, with no read of
    the mask on the host -> the feed."""
    cfg = pipeline.cfg
    m = inp["modified"]
    m3 = m[:, None, None]
    st.key_start.copy_(torch.where(m3, st.key_end, st.key_start))
    st.key_end.copy_(torch.where(m3, inp["audio"], st.key_end))
    if cfg.interpolate and not cfg.accel_fft:
        feed = transforms.interpolate(st.key_start, st.key_end, inp["interp"])
    else:
        feed = st.key_end
    carried = clone_state(st.chains)
    pipeline.advance(st.chains, feed[:, 0, :], feed[:, 1, :],
                     rows=inp["rows"])
    for t, sel in zip(st.chains,
                      pipeline.select_updated(st.chains, carried, m)):
        t.copy_(sel)
    return feed


def _raster(rend: Renderer, textures: dict, time, pipe: dict | None,
            n: int) -> tuple:
    """Channel planes of ``n`` streams, each broadcastable to (n, H, W):
    one pass chain for a batched module, else one a stream, each after
    its pipe row is loaded into the module's env."""
    if rend.module.batched:
        return rend.render_planes(textures, time, pipe)
    h, w = rend.height, rend.screen[0]
    per = []
    for s in range(n):
        if pipe:
            load_pipe_values(rend.module_env,
                             {k: v[s] for k, v in pipe.items()}, rend.device)
        per.append(rend.render_planes(
            {k: t[s] for k, t in textures.items()}, time[s], None))
    return tuple(
        torch.stack([device_plane(p[c], rend.device).expand(h, w)
                     for p in per])
        for c in range(4))


def _frames(rend: Renderer, planes, n: int, quantize: bool,
            guard: bool = True) -> torch.Tensor:
    """(n, H, W, 4) frames: float32, or uint8 when ``quantize`` (the
    serving wire format, quantized per channel plane before the
    interleave). ``guard``: the NaN guard, when it is on, checks the
    planes here (a compiled step checks them after its replay)."""
    if guard and profiling.nan_guard_enabled():
        profiling.check_nans(planes)
    pack = interleave_u8 if quantize else interleave
    return pack(planes, rend.height, rend.screen[0], rend.device,
                batch=(n,))


def _pipe_rows(pipe: dict | None) -> dict | None:
    return {k: np.asarray(_host(v), np.float32) for k, v in pipe.items()} \
        if pipe else None


class BatchedRenderer:
    """``n_streams`` streams of one module configuration (with ``rows``,
    their frames' band [r0, r1) of rows only, as ``Renderer``)."""

    def __init__(self, loaded: LoadedConfig, n_streams: int,
                 screen: tuple[int, int] | None = None, device="cuda",
                 rows: tuple[int, int] | None = None):
        self.loaded = loaded
        self.n_streams = n_streams
        self.renderer = Renderer(loaded, screen=screen, device=device,
                                 rows=rows)
        self.cfg = self.renderer.cfg
        self.device = self.renderer.device
        self.screen = self.renderer.screen

    def init_state(self) -> RenderState:
        return self.renderer.init_state(batch=(self.n_streams,))

    def step(self, state: RenderState, audio, modified, time, interp_mod,
             gravity_g, pipe: dict | None = None,
             quantize: bool = False) -> tuple[RenderState, torch.Tensor]:
        """One frame for every stream: ``audio`` (S, 2, bufsize),
        ``modified``/``time``/``interp_mod``/``gravity_g`` (S,) and pipe
        values name -> (S, ...) -> the new state and (S, H, W, 4)
        frames on the device ((S, H_band, W, 4) with ``rows``).
        ``interp_mod`` feeds only the CPU-path interpolation."""
        S = self.n_streams
        rend = self.renderer
        chains, key_start, key_end, feed = _advance(
            rend.pipeline, state, audio, modified, interp_mod, gravity_g)
        textures = rend.pipeline.textures_from(chains, feed[:, 0, :],
                                               feed[:, 1, :])
        planes = _raster(rend, textures, _host(time), _pipe_rows(pipe), S)
        return (RenderState(chains, key_start, key_end),
                _frames(rend, planes, S, quantize))

    def used_renderers(self) -> list[Renderer]:
        return [self.renderer]

    def jit_step(self, quantize: bool = True):
        """The compiled fleet step (:class:`CompiledFleetStep`), frames
        as :meth:`step` gives them."""
        return CompiledFleetStep(self, self.renderer.pipeline,
                                 [self.renderer], quantize)

    def _static_frames(self, st: RenderState, inp: dict, pipe,
                       quantize: bool):
        rend = self.renderer
        feed = _advance_static(rend.pipeline, st, inp)
        textures = rend.pipeline.textures_from(st.chains, feed[:, 0, :],
                                               feed[:, 1, :])
        planes = _raster(rend, textures, inp["time"], pipe, self.n_streams)
        return planes, _frames(rend, planes, self.n_streams, quantize, False)

    def update_textures(self, chains: FusedChainState, audio, gravity_g):
        """(S, 2, bufsize) -> (new chains, per-uniform (S, sz) textures),
        the update alone (no raster)."""
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        return self.renderer.pipeline.update(
            chains, audio[..., 0, :], audio[..., 1, :], gravity_g=gravity_g)


class MixedBatchedRenderer:
    """A fleet whose streams run different module variants in one step.

    Spectrum chains are deduplicated by (source, transform chain) across
    the variants into one union ``AudioPipeline``, whose fused update
    runs once for every stream; the raster stage groups the streams by
    their fixed variant, renders each group as a :class:`BatchedRenderer`
    does, and puts the frames back in stream order. All variants must
    agree on the DSP-shaping configuration (they share one spectrum
    state) and on the frame size; modules, knobs and colours are free.
    """

    _COMPAT_FIELDS = (
        "bufsize", "samplesize", "sample_rate", "bufscale", "avg_frames",
        "avg_window", "accel_fft", "smooth_factor", "smooth_pass",
        "interpolate", "mirror_input", "timecycle",
    )

    def __init__(self, loadeds: list[LoadedConfig], assign: list[int],
                 screen: tuple[int, int] | None = None, device="cuda",
                 rows: tuple[int, int] | None = None):
        if not loadeds:
            raise ValueError("need at least one module variant")
        if any(not 0 <= a < len(loadeds) for a in assign):
            raise ValueError("stream assignment out of range")
        base = loadeds[0].cfg
        for lc in loadeds[1:]:
            for f in self._COMPAT_FIELDS:
                if getattr(lc.cfg, f) != getattr(base, f):
                    raise ValueError(
                        f"module variants disagree on '{f}' — spectrum "
                        "state is shared, so DSP-shaping config must match")
        self.loadeds = loadeds
        self.assign = list(assign)
        self.n_streams = len(assign)
        self.renderers = [Renderer(lc, screen=screen, device=device,
                                   rows=rows)
                          for lc in loadeds]
        self.cfg = base
        self.device = self.renderers[0].device
        self.screen = self.renderers[0].screen
        for r in self.renderers[1:]:
            if r.screen != self.screen:
                raise ValueError("variants must share the frame geometry")

        # dedupe (source, chain) across variants into one union pipeline
        canon: dict[tuple, str] = {}
        self._variant_tex: list[dict[str, str]] = []
        for r in self.renderers:
            vm = {}
            for u in r.uniforms:
                key = (u.source, tuple(u.transforms))
                vm[u.name] = canon.setdefault(key, f"__u{len(canon)}")
            self._variant_tex.append(vm)
        union = [UniformSpec(cname, src, ch) for (src, ch), cname in canon.items()]
        self.pipeline = AudioPipeline(base, union, device=self.device)
        # static stream grouping per variant, and the inverse permutation
        # that puts the grouped frames back in stream order
        self._groups = [
            tuple(s for s, a in enumerate(self.assign) if a == k)
            for k in range(len(loadeds))
        ]
        order = [s for g in self._groups for s in g]
        inv = np.argsort(np.asarray(order))
        self._inv = (None if np.array_equal(inv, np.arange(len(order)))
                     else torch.as_tensor(inv, device=self.device))
        # each group's streams as an index on the device
        self._group_rows = [torch.as_tensor(g, dtype=torch.int64,
                                            device=self.device)
                            for g in self._groups]

    def init_state(self) -> RenderState:
        S = self.n_streams
        z = torch.zeros((S, 2, self.cfg.bufsize), dtype=torch.float32,
                        device=self.device)
        return RenderState(self.pipeline.init_state(batch=(S,)), z, z.clone())

    def step(self, state, audio, modified, time, interp_mod, gravity_g,
             pipe=None, quantize=False):
        """(S, H, W, 4) frames of every stream, each from its own
        variant (float32, or uint8 when ``quantize``; see
        :meth:`BatchedRenderer.step`)."""
        chains, key_start, key_end, feed = _advance(
            self.pipeline, state, audio, modified, interp_mod, gravity_g)
        textures = self.pipeline.textures_from(chains, feed[:, 0, :],
                                               feed[:, 1, :])
        _, frames = self._group_frames(textures, _host(time),
                                       _pipe_rows(pipe), quantize, True)
        return RenderState(chains, key_start, key_end), frames

    def _group_frames(self, textures, time, pipe, quantize: bool,
                      guard: bool):
        """Each variant's group rendered by its renderer, the frames put
        back in stream order -> (every group's planes, frames)."""
        parts, planes_all = [], []
        for k, idxs in enumerate(self._groups):
            if not idxs:
                continue
            rend = self.renderers[k]
            rows = list(idxs)
            rows_t = self._group_rows[k]
            sub_tex = {un: textures[cn][rows_t]
                       for un, cn in self._variant_tex[k].items()}
            sub_pipe = {n: v[rows_t] if isinstance(v, torch.Tensor)
                        else v[rows] for n, v in pipe.items()} if pipe \
                else None
            planes = _raster(rend, sub_tex, time[rows_t]
                             if isinstance(time, torch.Tensor)
                             else time[rows], sub_pipe, len(rows))
            planes_all.extend(planes)
            parts.append(_frames(rend, planes, len(rows), quantize, guard))
        frames = torch.cat(parts) if len(parts) > 1 else parts[0]
        if self._inv is not None:
            frames = frames[self._inv]
        return planes_all, frames

    def used_renderers(self) -> list[Renderer]:
        """The variants' renderers that render some stream."""
        return [r for r, g in zip(self.renderers, self._groups) if g]

    def jit_step(self, quantize: bool = True):
        """The compiled fleet step (:class:`CompiledFleetStep`), frames
        as :meth:`step` gives them."""
        return CompiledFleetStep(self, self.pipeline, self.renderers, quantize)

    def _static_frames(self, st: RenderState, inp: dict, pipe,
                       quantize: bool):
        feed = _advance_static(self.pipeline, st, inp)
        textures = self.pipeline.textures_from(st.chains, feed[:, 0, :],
                                               feed[:, 1, :])
        return self._group_frames(textures, inp["time"], pipe, quantize,
                                  False)


class ShardedRenderer:
    """A fleet over the devices of ``mesh``: device [i, j] of
    ``parallel.mesh.shard_grid`` renders stream block ``slices[i]``
    (``parallel.mesh.stream_slices``) in row band ``bands[j]``
    (``parallel.mesh.row_bands``), a :class:`BatchedRenderer` of
    ``loadeds[0]`` when the fleet runs one variant, else a
    :class:`MixedBatchedRenderer` of the variants its block of
    ``assign`` uses (only those are built). The per-device lists
    (``devices``, ``blocks``, ``shards``, states and frames) run in
    mesh order, i major. The devices of a row group (one stream block)
    each hold a replica of the block's state, as JAX replicates
    ``P(stream_axes)`` state over rows, and advance it from the same
    inputs."""

    def __init__(self, loadeds: list[LoadedConfig], assign: list[int], mesh,
                 screen: tuple[int, int] | None = None):
        from glava_tpu_torch.parallel.mesh import (
            row_bands, shard_grid, stream_slices,
        )

        if not loadeds:
            raise ValueError("need at least one module variant")
        if any(not 0 <= a < len(loadeds) for a in assign):
            raise ValueError("stream assignment out of range")
        grid = shard_grid(mesh)
        height = screen[1] if screen else loadeds[0].cfg.geometry[3]
        self.slices = stream_slices(mesh, len(assign))
        self.bands = row_bands(mesh, height)
        self.n_streams = len(assign)
        self.devices, self.blocks, self.shards = [], [], []
        for i, sl in enumerate(self.slices):
            sub = list(assign[sl])
            used = sorted(set(sub))
            for j, band in enumerate(self.bands):
                rows = band if len(self.bands) > 1 else None
                if len(loadeds) == 1:
                    sh = BatchedRenderer(loadeds[0], len(sub), screen,
                                         device=grid[i, j], rows=rows)
                else:
                    sh = MixedBatchedRenderer(
                        [loadeds[k] for k in used],
                        [used.index(a) for a in sub], screen,
                        device=grid[i, j], rows=rows)
                self.devices.append(sh.device)
                self.blocks.append((sl, band))
                self.shards.append(sh)
        self.cfg = self.shards[0].cfg
        self.screen = self.shards[0].screen
        if any(sh.screen != self.screen for sh in self.shards):
            raise ValueError("variants must share the frame geometry")

    def init_state(self) -> list[RenderState]:
        """One state a device, each on its device."""
        return [sh.init_state() for sh in self.shards]

    def step(self, states: list[RenderState], audio, modified, time,
             interp_mod, gravity_g, pipe: dict | None = None,
             quantize: bool = False):
        """:meth:`BatchedRenderer.step` on every device, back to back on
        each device's current stream with no host synchronisation
        between them: ``audio`` (S, 2, bufsize) on the host (one copy to
        each device of its block; every device of a row group takes the
        same); the per-stream inputs and pipe rows are sliced per block.
        Returns the new per-device states and the per-device
        (S_i, H_band, W, 4) frames, each on its device."""
        modified, time = _host(modified), _host(time)
        interp_mod, gravity_g = _host(interp_mod), _host(gravity_g)
        pipe = _pipe_rows(pipe)
        out_states, frames = [], []
        for sh, (sl, _), st in zip(self.shards, self.blocks, states):
            a = torch.as_tensor(audio[sl], dtype=torch.float32).to(
                sh.device, non_blocking=True)
            st, fr = sh.step(st, a, modified[sl], time[sl], interp_mod[sl],
                             gravity_g[sl],
                             {k: v[sl] for k, v in pipe.items()} if pipe
                             else None, quantize)
            out_states.append(st)
            frames.append(fr)
        return out_states, frames

    def used_renderers(self) -> list[Renderer]:
        return [r for sh in self.shards for r in sh.used_renderers()]

    def jit_step(self, quantize: bool = True):
        """The compiled sharded step (:class:`CompiledShardedStep`):
        one graph a device block, replayed back to back."""
        return CompiledShardedStep(self, quantize)


class CompiledFleetStep:
    """``jit_step`` of a :class:`BatchedRenderer` or
    :class:`MixedBatchedRenderer`: ``step(state, audio, modified, time,
    interp_mod, gravity_g, pipe=None) -> (state, frames)`` with the
    eager step's arguments, (S, ...) on the host or the device. The
    state is donated; the audio (S, 2, bufsize), the mask, the
    per-stream scalars, the parameter rows and the pipe rows go into
    static inputs in one host-to-device copy (``compiled.Step``). The
    NaN guard, when it is on, checks the frame's planes after the
    replay."""

    def __init__(self, br, pipeline: AudioPipeline, renderers: list,
                 quantize: bool):
        self.br = br
        self.pipeline = pipeline
        self.quantize = quantize
        self.step = compiled.Step(
            br.device,
            {"audio": torch.float32, "modified": torch.bool,
             "time": torch.float32, "interp": torch.float32,
             "rows": torch.float32},
            name=", ".join(dict.fromkeys(r.module.name for r in renderers)))

    def __call__(self, state, audio, modified, time, interp_mod, gravity_g,
                 pipe: dict | None = None):
        ts = profiling.begin()
        out = self.call(state, audio, modified, time, interp_mod, gravity_g,
                        pipe)
        if ts:
            profiling.end("step", ts)
        return out

    def call(self, state, audio, modified, time, interp_mod, gravity_g,
             pipe: dict | None = None):
        """The call without its ``step`` span (a sharded step's part)."""
        S = self.br.n_streams
        st = self.step.donate(state)

        def per_stream(v, dtype):
            if isinstance(v, torch.Tensor):
                return v.reshape(S).to(dtype)
            return np.broadcast_to(np.asarray(v, compiled.NP[dtype]), (S,))

        rows = self.pipeline.host_rows(len(self.pipeline.fft_uniforms) * S,
                                       gravity_g=_host(gravity_g))
        self.step.load(audio=audio, modified=per_stream(modified, torch.bool),
                       time=per_stream(time, torch.float32),
                       interp=per_stream(interp_mod, torch.float32),
                       rows=rows, pipe=pipe)
        guard = profiling.nan_guard_enabled()
        frames, nan = self.step.run(guard, self._body)
        if nan is not None and bool(nan):
            raise FloatingPointError("NaN in frame")
        return st, frames

    def _body(self, guard: bool):
        planes, frames = self.br._static_frames(
            self.step.state, self.step.inputs, self.step.pipe() or None,
            self.quantize)
        if not guard:
            return frames, None
        flags = [torch.isnan(p).any() for p in planes
                 if isinstance(p, torch.Tensor)]
        return frames, torch.stack(flags).any()


class CompiledShardedStep:
    """``jit_step`` of a :class:`ShardedRenderer`: one compiled fleet
    step a device block, each replaying its own graph, back to back on
    each device's current stream with no host synchronisation between
    them (the counterpart of the JAX one ``jit`` over the mesh,
    glava_tpu/parallel/batch.py:151-156). Arguments as
    :meth:`ShardedRenderer.step`, on the host; each block's slice goes
    into its device's static inputs."""

    def __init__(self, sr, quantize: bool):
        self.sr = sr
        self.steps = [sh.jit_step(quantize) for sh in sr.shards]

    def __call__(self, states, audio, modified, time, interp_mod, gravity_g,
                 pipe: dict | None = None):
        ts = profiling.begin()
        modified, time = _host(modified), _host(time)
        interp_mod, gravity_g = _host(interp_mod), _host(gravity_g)
        audio = _host(audio)
        pipe = _pipe_rows(pipe)
        out_states, frames = [], []
        for step, (sl, _), st in zip(self.steps, self.sr.blocks, states):
            st, fr = step.call(st, audio[sl], modified[sl], time[sl],
                               interp_mod[sl], gravity_g[sl],
                               {k: v[sl] for k, v in pipe.items()} if pipe
                               else None)
            out_states.append(st)
            frames.append(fr)
        if ts:
            profiling.end("step", ts)
        return out_states, frames


def example_batch(br, rng_seed: int = 0) -> dict:
    """Synthetic per-stream inputs for checks and timing: one stereo
    tone pair a stream (audio on the renderer's device; the per-stream
    mask and scalars on the host, as a serving loop has them)."""
    S = br.n_streams
    cfg = br.cfg
    rng = np.random.default_rng(rng_seed)
    freqs = rng.uniform(100.0, 8000.0, size=S)
    t = np.arange(cfg.bufsize) / cfg.sample_rate
    audio = np.stack([
        np.stack([0.4 * np.sin(2 * np.pi * f * t),
                  0.4 * np.sin(2 * np.pi * (f * 1.5) * t)])
        for f in freqs
    ]).astype(np.float32)
    return dict(
        audio=torch.as_tensor(audio, device=br.device),
        modified=np.ones((S,), bool),
        time=np.zeros((S,), np.float32),
        interp_mod=np.ones((S,), np.float32),
        gravity_g=np.full((S,), cfg.gravity_step / cfg.nominal_ups, np.float32),
    )

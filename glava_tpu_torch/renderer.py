"""Renderer: config -> a (state, audio) -> (state, frame) step on torch.

The device-side equivalent of ``rd_update`` (glava/render.c:1743-2417):
per frame it runs the audio update when a new ring snapshot arrived,
rasterizes the module's pass chain and composites the result. The
eager step (:meth:`Renderer.step_planes` and its wire forms) takes the
JAX package's ``lax.cond`` on ``modified`` as a Python ``if``;
:meth:`Renderer.jit_step` is the compiled step, the counterpart of the
JAX ``jit_step``: captured into a CUDA graph a branch and replayed
(``compiled.py``). On the CPU path with
``setinterpolate`` on, the feed blends the two newest keyframes by
``interp_mod`` and the update runs every frame (render.c:1792-1809,
glava_tpu/renderer.py:154-162).

With ``rows`` = (r0, r1) the renderer draws only that band of the
frame's rows (a device's band of a mesh's rows axis,
``parallel.mesh.row_bands``): frames are (H_band, W, 4). A module that
takes the band (``ModuleBuild.banded``: every native module) builds for
it; any other (a GLSL shader module, whose interpreter fetches ``prev``
at any row) renders every pass over the whole frame and keeps its band,
counted in :data:`whole_frame_bands`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from glava_tpu_torch import compiled
from glava_tpu_torch.config.loader import LoadedConfig, builtin_variables
from glava_tpu_torch.device import resolve
from glava_tpu_torch.ops import transforms
from glava_tpu_torch.pipeline import AudioPipeline, FusedChainState, UniformSpec
from glava_tpu_torch.render.base import (
    ModuleContext, PassInputs, cut_rows, interleave, interleave_u8, mul,
    pipe_components, f32_tensor,
)
from glava_tpu_torch.render.modules import build_module, module_uniforms
from glava_tpu_torch.utils import profiling

# band renders of a module that drew the whole frame to keep its band
# (a shader module on a mesh's rows axis)
whole_frame_bands = 0


class RenderState(NamedTuple):
    chains: FusedChainState      # the fused update's carry
    key_start: torch.Tensor      # (2, bufsize) interpolation start keyframe
    key_end: torch.Tensor        # (2, bufsize) interpolation end keyframe


@dataclass
class Renderer:
    loaded: LoadedConfig
    screen: tuple[int, int] | None = None
    device: str | torch.device = "cuda"
    rows: tuple[int, int] | None = None   # a band [r0, r1) of the rows

    def __post_init__(self):
        self.device = resolve(self.device)
        cfg = self.cfg = self.loaded.cfg
        if self.screen is None:
            self.screen = (cfg.geometry[2], cfg.geometry[3])
        if self.rows is not None:
            r0, r1 = self.rows = tuple(int(r) for r in self.rows)
            if not 0 <= r0 < r1 <= self.screen[1]:
                raise ValueError(f"rows {self.rows} are not a band of a "
                                 f"frame of height {self.screen[1]}")
        # the height of the frames this renderer draws
        self.height = (self.screen[1] if self.rows is None
                       else self.rows[1] - self.rows[0])
        # user shader modules registered by this load shadow built-ins
        overrides = self.loaded.module_overrides
        self.uniforms = [UniformSpec(*u) for u in
                         module_uniforms(self.loaded.module, overrides)]
        self.pipeline = AudioPipeline(cfg, self.uniforms, device=self.device)
        env = self.module_env = self.loaded.env
        env.variables.update(builtin_variables(cfg))
        mctx = ModuleContext(
            cfg=cfg,
            env=env,
            screen=self.screen,
            sz=self.pipeline.sz,
            device=self.device,
            channels=1 if cfg.mirror_input else 2,
            rows=self.rows,
        )
        self.module_ctx = mctx
        self.module = build_module(self.loaded.module, mctx, overrides)
        # the band a module drew over the whole frame is cut from it
        self._cut = self.rows is not None and not self.module.banded
        # xroot/none opacity composites over the `setbg` clear color, or
        # over a `setbgimg` wallpaper sampled at the window geometry (the
        # reference's root-pixmap copy, xwin.c:345-472): (H, W) planes on
        # the device. The engine polls the file and feeds changed planes
        # through the reserved ``__bg__`` pipe key (render.c:1832-1837).
        self._bg_planes = tuple(np.float32(c) for c in cfg.clear_color)
        self.bg_path: str | None = None
        if cfg.copy_desktop and cfg.background_image \
                and not cfg.premultiply_alpha:
            self.bg_path = cfg.background_image
            self._bg_planes = tuple(
                torch.as_tensor(p, device=self.device)
                for p in self.band_of(self.load_bg_planes()))

    def band_of(self, planes) -> tuple:
        """Whole-frame channel planes cut to this renderer's band (a
        plane broadcast over rows stays as it is)."""
        if self.rows is None:
            return tuple(planes)
        return tuple(cut_rows(p, *self.rows) for p in planes)

    def load_bg_planes(self) -> tuple[np.ndarray, ...]:
        """Read the ``setbgimg`` wallpaper and build the 4 (H, W)
        bottom-up background channel planes sampled at the window
        geometry (the root-pixmap copy, xwin.c:345-472)."""
        from glava_tpu_torch.runtime.sinks import read_png

        cfg = self.cfg
        img = read_png(cfg.background_image).astype(np.float32) / 255.0
        gx, gy = cfg.geometry[0], cfg.geometry[1]
        w, h = self.screen
        canvas = np.broadcast_to(
            np.asarray(cfg.clear_color, np.float32), (h, w, 4)
        ).copy()
        ih, iw = img.shape[:2]
        y0, y1 = max(gy, 0), min(gy + h, ih)
        x0, x1 = max(gx, 0), min(gx + w, iw)
        if y1 > y0 and x1 > x0:
            canvas[y0 - gy:y1 - gy, x0 - gx:x1 - gx] = img[y0:y1, x0:x1]
        canvas[..., 3] = 1.0  # the root pixmap is opaque
        canvas = canvas[::-1]  # bottom-up
        return tuple(canvas[..., c].copy() for c in range(4))

    # -- state -------------------------------------------------------------

    def init_state(self, batch: tuple[int, ...] = ()) -> RenderState:
        z = torch.zeros(batch + (2, self.cfg.bufsize), dtype=torch.float32,
                        device=self.device)
        return RenderState(
            chains=self.pipeline.init_state(batch),
            key_start=z,
            key_end=z.clone(),
        )

    # -- the step -----------------------------------------------------------

    def step_planes(
        self,
        state: RenderState,
        audio,                  # (2, bufsize) current ring snapshot
        modified: bool,         # new audio since the last frame?
        time: float,            # seconds (wraps at timecycle)
        interp_mod: float = 1.0,  # min(uratio*kcounter, 1); read only on
        #                           the CPU path (render.c:2161-2173)
        gravity_g=None,         # gravity_step / measured UPS
        pipe: dict | None = None,   # live pipe uniform values (name ->
        #                            value), read by `@name:default` knobs;
        #                            the reserved ``__bg__`` key holds the
        #                            live (4, H, W) wallpaper planes
    ) -> tuple[RenderState, tuple]:
        bg = None
        if pipe and "__bg__" in pipe:
            pipe = dict(pipe)
            bg = pipe.pop("__bg__")
            bg = self.band_of(bg[i] for i in range(4))
        # Keyframe push on update (render.c:2348-2353): start <- end,
        # end <- new buffers.
        if modified:
            key_start = state.key_end
            key_end = torch.as_tensor(audio, dtype=torch.float32,
                                      device=self.device)
        else:
            key_start, key_end = state.key_start, state.key_end
        chains, feed = self._update(state.chains, key_start, key_end,
                                    modified, interp_mod,
                                    gravity_g=gravity_g)
        planes = self._planes(chains, feed, time, pipe, bg)
        if profiling.nan_guard_enabled():
            profiling.check_nans(planes)
        return RenderState(chains, key_start, key_end), planes

    def _update(self, chains, key_start, key_end, modified: bool, interp_mod,
                gravity_g=None, rows=None):
        """The audio update of one frame -> (chains, feed)."""
        cfg = self.cfg
        if cfg.interpolate and not cfg.accel_fft:
            # CPU-path interpolation; the accel path force-disables it
            # (render.c:2161-2173). The feed changes every frame, so the
            # transforms rerun every frame.
            feed = transforms.interpolate(key_start, key_end, interp_mod)
        else:
            feed = key_end
            # transforms run only when new audio arrived (render.c:2122);
            # otherwise the carried state is reused (render.c:2268-2272)
            if not modified:
                return chains, feed
        chains = self.pipeline.advance(chains, feed[..., 0, :],
                                       feed[..., 1, :], gravity_g=gravity_g,
                                       rows=rows)
        return chains, feed

    def _planes(self, chains, feed, time, pipe, bg) -> tuple:
        """The frame's channel planes from the (updated) chains."""
        # stateless uniforms (wave) read the feed
        textures = self.pipeline.textures_from(
            chains, feed[..., 0, :], feed[..., 1, :])
        if self.module.batched:
            # one stream of a module that takes a stream axis
            rows = None if not pipe else {
                k: f32_tensor(v, self.device)[None] for k, v in pipe.items()}
            planes = self.render_planes(
                {k: t[None] for k, t in textures.items()}, time, rows, bg)
            return tuple(p[0] if np.ndim(p) == 3 else p for p in planes)
        if pipe:
            load_pipe_values(self.module_env, pipe, self.device)
        return self.render_planes(textures, time, None, bg)

    def render_planes(self, textures: dict, time, pipe: dict | None,
                      bg: tuple | None = None) -> tuple:
        """The module's pass chain and the background composite (over
        ``bg`` planes when given, else the load's), for the module's own
        input layout (a stream axis when it is batched: ``pipe`` is then
        name -> (S, ...) rows; an unbatched module reads the values the
        step loaded into its env)."""
        planes = self.module.render(
            PassInputs(prev=None, textures=textures, time=time, pipe=pipe))
        if self._cut:
            global whole_frame_bands
            whole_frame_bands += 1
            planes = self.band_of(planes)
        if not self.cfg.premultiply_alpha:
            # xroot/none opacity: the final draw blends src-alpha over
            # the background (render.c:1468-1469, 1700, 2028), per
            # channel — alpha composites against the background alpha.
            a = planes[3]
            planes = tuple(
                mul(c, a) + mul(b, 1.0 - a)
                for c, b in zip(planes, bg or self._bg_planes)
            )
        return planes

    def step(self, *args, **kwargs) -> tuple[RenderState, torch.Tensor]:
        """:meth:`step_planes` + the (H, W, 4) float32 RGBA frame."""
        st, planes = self.step_planes(*args, **kwargs)
        return st, interleave(planes, self.height, self.screen[0], self.device)

    def step_u8(self, *args, **kwargs) -> tuple[RenderState, torch.Tensor]:
        """:meth:`step_planes` + the (H, W, 4) uint8 RGBA frame on the
        device, quantized per channel before interleaving (the JAX
        ``jit_step(quantize=True)``)."""
        st, planes = self.step_planes(*args, **kwargs)
        return st, interleave_u8(planes, self.height, self.screen[0],
                                 self.device)

    def step_yuv420(self, *args, **kwargs) -> tuple[RenderState, torch.Tensor]:
        """:meth:`step_planes` + the frame packed to YUV420 on the device
        (the JAX ``jit_step(yuv420=True)``): ONE contiguous uint8 buffer,
        the (H, W) Y plane then the (H/2, W/2) U and V planes, top-down,
        1.5 B/px on the device-to-host wire instead of RGBA8's 4. Needs
        even dimensions."""
        w, h = self.screen[0], self.height
        if h % 2 or w % 2:
            raise ValueError("yuv420 packing needs even dimensions")
        st, planes = self.step_planes(*args, **kwargs)
        return st, yuv420_buffer(planes, h, w, self.device)

    # -- the compiled step -------------------------------------------------

    def jit_step(self, quantize: bool = False, yuv420: bool = False):
        """The compiled step, the counterpart of the JAX ``jit_step``:
        ``step(state, audio, modified, time, interp_mod=1.0,
        gravity_g=None, pipe=None) -> (state, frame)``, the frame as
        :meth:`step` gives it, or :meth:`step_u8`'s with ``quantize``,
        or :meth:`step_yuv420`'s with ``yuv420``. The state is donated.
        On a card each branch (``modified`` or not) is captured into a
        CUDA graph once and replayed; on the CPU the same static-buffer
        step runs eagerly (``compiled.py``). A user Python module's
        passes run guarded (``compiled.user_pass``): the first call of a
        branch raises ``compiled.Uncapturable`` naming a module that
        reads on the host."""
        h, w = self.height, self.screen[0]
        if yuv420:
            if h % 2 or w % 2:
                raise ValueError("yuv420 packing needs even dimensions")
            return CompiledStep(
                self, lambda p: yuv420_buffer(p, h, w, self.device))
        if quantize:
            return CompiledStep(
                self, lambda p: interleave_u8(p, h, w, self.device))
        return CompiledStep(self, lambda p: interleave(p, h, w, self.device))

    # -- golden-frame evaluation (render.c:2419-2453) -----------------------

    def test_evaluate(self, frame) -> bool:
        """Assert every pixel equals `settesteval` within +-0.5/255."""
        expect = self.cfg.test_eval_color
        if expect is None:
            raise ValueError("no `settesteval` color configured")
        got = frame.cpu().numpy() if isinstance(frame, torch.Tensor) else np.asarray(frame)
        if got.dtype == np.uint8:
            got = got.astype(np.float64) / 255.0
        else:
            got = got.astype(np.float64)
        want = np.asarray(expect, dtype=np.float64)
        return bool(np.all(np.abs(got - want) <= 0.5 / 255.0 + 1e-9))


class CompiledStep:
    """:meth:`Renderer.jit_step`'s callable. Per call: the audio
    snapshot, ``time``, ``interp_mod`` and the parameter rows (from
    ``gravity_g``) and the pipe values go into static inputs in one
    host-to-device copy; the ``__bg__`` wallpaper planes into static
    planes, copied only when the caller hands over another tensor. A
    branch is ``(modified, wallpaper given, NaN guard on)``. The
    keyframe push, the update and the raster run in place on the
    donated state (:meth:`_body`). A GLSL shader module's loops count
    the pixels they truncate at the fuel cap on the device: the caller
    reads the count with ``glsl_shader.fuel_check`` (the Engine after
    each frame, at most once a second, and at the end of a run)."""

    def __init__(self, rend: Renderer, pack):
        self.rend = rend
        self.pack = pack
        self.rows_b = len(rend.pipeline.fft_uniforms)
        self.bg = None          # static (4, H, W) wallpaper planes
        self._bg_src = None
        self.step = compiled.Step(
            rend.device,
            {"audio": torch.float32, "time": torch.float32,
             "interp": torch.float32, "rows": torch.float32},
            name=rend.module.name)

    def __call__(self, state, audio, modified, time, interp_mod=1.0,
                 gravity_g=None, pipe=None):
        ts = profiling.begin()
        rend = self.rend
        st = self.step.donate(state)
        pipe = dict(pipe or {})
        bg = pipe.pop("__bg__", None)
        if bg is not None and bg is not self._bg_src:
            if self.bg is None:
                self.bg = torch.empty((4,) + tuple(bg.shape[1:]),
                                      dtype=torch.float32, device=rend.device)
            self.bg.copy_(torch.as_tensor(bg, dtype=torch.float32))
            self._bg_src = bg
        self.step.load(audio=audio, time=np.float32(time),
                       interp=np.float32(interp_mod),
                       rows=rend.pipeline.host_rows(self.rows_b,
                                                    gravity_g=gravity_g),
                       pipe=pipe)
        guard = profiling.nan_guard_enabled()
        out = self.step.run((bool(modified), bg is not None, guard),
                            self._body)
        frame, nan = out if guard else (out, None)
        if nan is not None and bool(nan):
            raise FloatingPointError("NaN in frame")
        if ts:
            profiling.end("step", ts)
        return st, frame

    def _body(self, branch):
        modified, with_bg, guard = branch
        pipe = self.step.pipe()
        rend, st, inp = self.rend, self.step.state, self.step.inputs
        if modified:
            # keyframe push in place (render.c:2348-2353)
            st.key_start.copy_(st.key_end)
            st.key_end.copy_(inp["audio"])
        chains, feed = rend._update(st.chains, st.key_start, st.key_end,
                                    modified, inp["interp"], rows=inp["rows"])
        bg = rend.band_of(self.bg[i] for i in range(4)) if with_bg else None
        planes = rend._planes(chains, feed, inp["time"], pipe, bg)
        frame = self.pack(planes)
        if not guard:
            return frame
        flags = [torch.isnan(p).any() for p in planes
                 if isinstance(p, torch.Tensor)]
        return frame, torch.stack(flags).any()


def load_pipe_values(env, pipe: dict, device) -> None:
    """Load one stream's pipe values (name -> value) into a module's env,
    as the JAX step does: a module without a stream axis reads them
    there, in the knobs it evaluates inside the pass (a shader module's
    ``@name`` knobs); build-time knobs keep the load's values. Each
    value is a float32 tensor on ``device`` (a compiled step binds its
    static inputs), a vecN a component tuple of them."""
    vals = {k: pipe_components(f32_tensor(v, device))
            for k, v in pipe.items()}
    env.pipe_values.clear()
    env.pipe_values.update(vals)


def _yuv_from_rgb(rgb: torch.Tensor, h: int, w: int):
    """BT.601 full-range (Y, U, V) uint8 planes of (3, H, W) 0-255
    float32 top-down r, g, b planes, 2x2-mean chroma, each stage
    round-half-to-even (``torch.round``, as ``jnp.round``). U and V
    share their reduction and rounding launches (the per-element math is
    the JAX package's)."""
    r, g, b = rgb
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    uv = torch.stack([u, v]).reshape(2, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def to8(p):
        return torch.clamp(torch.round(p), 0.0, 255.0).to(torch.uint8)

    uv = to8(uv)
    return to8(y), uv[0], uv[1]


def yuv420_pack_planes(planes, h: int, w: int, device="cpu"):
    """Planar form of :func:`yuv420_pack` (the same per-element math):
    consumes the channel planes directly, so the interleaved RGBA frame
    never materializes on the yuv420 wire. Planes may be tensors, numpy
    arrays or scalars broadcastable to (H, W), GL bottom-up."""
    rgb = torch.stack([
        torch.as_tensor(p, dtype=torch.float32, device=device).expand(h, w)
        for p in planes[:3]])
    rgb = torch.clamp(torch.round(rgb * 255.0), 0.0, 255.0).flip(1)
    return _yuv_from_rgb(rgb, h, w)


def yuv420_buffer(planes, h: int, w: int, device="cpu") -> torch.Tensor:
    """:func:`yuv420_pack_planes` as ONE contiguous uint8 buffer, Y then
    U then V: the frame on the yuv420 wire, fetched in one copy."""
    return torch.cat([p.reshape(-1)
                      for p in yuv420_pack_planes(planes, h, w, device)])


def yuv420_pack(frame: torch.Tensor):
    """f32 RGBA [0,1] (h, w, 4), GL bottom-up -> (Y, U, V) uint8
    planes, top-down, BT.601 full-range, 2x2-mean chroma (C420jpeg
    siting), on the frame's device."""
    img = torch.clamp(torch.round(frame * 255.0), 0.0, 255.0).flip(0)
    h, w = img.shape[:2]
    return _yuv_from_rgb(img[..., :3].permute(2, 0, 1), h, w)


def yuv420_pack_host(frame_u8: np.ndarray):
    """RGBA8 (h, w, 4), GL bottom-up -> (Y, U, V) uint8 planes, top-down,
    BT.601 full-range, 2x2-mean chroma (C420jpeg siting), in numpy: the
    mirror of :func:`yuv420_pack` for sinks fed RGBA8 frames (within 1
    LSB of the device path, from float32 operation order)."""
    img = frame_u8[::-1].astype(np.float32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    h2, w2 = r.shape[0] // 2, r.shape[1] // 2

    def ds(p):
        return p.reshape(h2, 2, w2, 2).mean(axis=(1, 3))

    def to8(p):
        return np.clip(np.rint(p), 0, 255).astype(np.uint8)

    return to8(y), to8(ds(u)), to8(ds(v))

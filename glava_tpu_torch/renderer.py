"""Renderer: config -> a (state, audio) -> (state, frame) step on torch.

The device-side equivalent of ``rd_update`` (glava/render.c:1743-2417):
per frame it runs the audio update when a new ring snapshot arrived,
rasterizes the module's pass chain and composites the result. Torch
runs eagerly, so the JAX package's ``lax.cond`` on ``modified`` is a
Python ``if`` here and there is no compile step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from glava_tpu_torch.config.loader import LoadedConfig, builtin_variables
from glava_tpu_torch.device import resolve
from glava_tpu_torch.pipeline import AudioPipeline, FusedChainState, UniformSpec
from glava_tpu_torch.render.base import (
    ModuleContext, PassInputs, interleave, interleave_u8, mul,
)
from glava_tpu_torch.render.modules import build_module, module_uniforms


class RenderState(NamedTuple):
    chains: FusedChainState      # the fused update's carry
    key_start: torch.Tensor      # (2, bufsize) interpolation start keyframe
    key_end: torch.Tensor        # (2, bufsize) interpolation end keyframe


@dataclass
class Renderer:
    loaded: LoadedConfig
    screen: tuple[int, int] | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve(self.device)
        cfg = self.cfg = self.loaded.cfg
        if self.screen is None:
            self.screen = (cfg.geometry[2], cfg.geometry[3])
        if cfg.copy_desktop and cfg.background_image \
                and not cfg.premultiply_alpha:
            raise NotImplementedError(
                "the setbgimg wallpaper composite is not yet ported "
                "(ROADMAP slice 5)")
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
        )
        self.module = build_module(self.loaded.module, mctx, overrides)
        # xroot/none opacity composites over the `setbg` clear color
        self._bg_planes = tuple(np.float32(c) for c in cfg.clear_color)

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
        interp_mod: float = 1.0,  # min(uratio*kcounter, 1); unused on the
        #                           accel path (render.c:2161-2173)
        gravity_g=None,         # gravity_step / measured UPS
        pipe: dict | None = None,   # live pipe uniform values (name ->
        #                            value), read by `@name:default` knobs
    ) -> tuple[RenderState, tuple]:
        # Keyframe push on update (render.c:2348-2353): start <- end,
        # end <- new buffers.
        if modified:
            key_start = state.key_end
            key_end = torch.as_tensor(audio, dtype=torch.float32,
                                      device=self.device)
            # transforms run only when new audio arrived (render.c:2122);
            # otherwise the carried state is reused (render.c:2268-2272)
            chains = self.pipeline.advance(
                state.chains, key_end[..., 0, :], key_end[..., 1, :],
                gravity_g=gravity_g)
        else:
            key_start, key_end = state.key_start, state.key_end
            chains = state.chains

        # stateless uniforms (wave) read the feed: the newest keyframe
        textures = self.pipeline.textures_from(
            chains, key_end[..., 0, :], key_end[..., 1, :])
        if self.module.batched:
            # one stream of a module that takes a stream axis
            rows = None if not pipe else {
                k: np.asarray(v, np.float32)[None] for k, v in pipe.items()}
            planes = self.render_planes(
                {k: t[None] for k, t in textures.items()}, time, rows)
            planes = tuple(p[0] if np.ndim(p) == 3 else p for p in planes)
        else:
            planes = self.render_planes(textures, time, pipe)
        return RenderState(chains, key_start, key_end), planes

    def render_planes(self, textures: dict, time, pipe: dict | None) -> tuple:
        """The module's pass chain and the background composite, for the
        module's own input layout (a stream axis when it is batched:
        ``pipe`` is then name -> (S, ...) rows)."""
        if pipe and "__bg__" in pipe:
            raise NotImplementedError(
                "the live wallpaper (`__bg__` pipe key) is not yet ported "
                "(ROADMAP slice 5)")
        if pipe and not self.module.batched:
            raise NotImplementedError(
                f"pipe values for module '{self.module.name}' are not yet "
                "ported: bars, radial and wave take them (ROADMAP slice 5)")
        planes = self.module.render(
            PassInputs(prev=None, textures=textures, time=time, pipe=pipe))
        if not self.cfg.premultiply_alpha:
            # xroot/none opacity: the final draw blends src-alpha over
            # the background (render.c:1468-1469, 1700, 2028), per
            # channel — alpha composites against the background alpha.
            a = planes[3]
            planes = tuple(
                mul(c, a) + mul(b, 1.0 - a)
                for c, b in zip(planes, self._bg_planes)
            )
        return planes

    def step(self, *args, **kwargs) -> tuple[RenderState, torch.Tensor]:
        """:meth:`step_planes` + the (H, W, 4) float32 RGBA frame."""
        st, planes = self.step_planes(*args, **kwargs)
        return st, interleave(planes, self.screen[1], self.screen[0], self.device)

    def step_u8(self, *args, **kwargs) -> tuple[RenderState, torch.Tensor]:
        """:meth:`step_planes` + the (H, W, 4) uint8 RGBA frame on the
        device, quantized per channel before interleaving (the JAX
        ``jit_step(quantize=True)``)."""
        st, planes = self.step_planes(*args, **kwargs)
        return st, interleave_u8(planes, self.screen[1], self.screen[0],
                                 self.device)

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


def yuv420_pack_host(frame_u8: np.ndarray):
    """RGBA8 (h, w, 4), GL bottom-up -> (Y, U, V) uint8 planes, top-down,
    BT.601 full-range, 2x2-mean chroma (C420jpeg siting), in numpy."""
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

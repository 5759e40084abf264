"""Typed renderer configuration — the target of ``#request`` handlers.

Field defaults replicate the reference's initial state: renderer
requests at glava/render.c:876-889 and ``gl_data`` defaults at
render.c:894-953. Window-system fields (hints, EWMH types/states,
opacity, clickthrough, geometry) have no TPU meaning per se; they are
retained one-to-one so existing configs evaluate, and are surfaced to
frame sinks as presentation hints (SURVEY.md section 7 capability map).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class RenderConfig:
    # --- module / shader surface -------------------------------------
    module: str = "bars"               # `mod` (render.c:1100-1110)
    shader_version: int = 330          # `setshaderversion` (accepted, unused)
    context_version: tuple[int, int] = (3, 3)  # `setversion` (accepted, unused)

    # --- audio pipeline ----------------------------------------------
    bufsize: int = 8192                # `setbufsize` (render.c:880)
    sample_rate: int = 22000           # `setsamplerate` (render.c:881)
    samplesize: int = 1024             # `setsamplesize` (render.c:882)
    bufscale: int = 1                  # `setbufscale` (render.c:908)
    audio_source: str | None = None    # `setsource`
    mirror_input: bool = False         # `setmirror`

    # --- spectrum dynamics --------------------------------------------
    fft_scale: float = 10.2            # `setfftscale` (render.c:930)
    fft_cutoff: float = 0.3            # `setfftcutoff` (render.c:931)
    gravity_step: float = 4.2          # `setgravitystep` (render.c:911)
    avg_frames: int = 6                # `setavgframes` (render.c:909)
    avg_window: bool = True            # `setavgwindow` (render.c:910)
    interpolate: bool = True           # `setinterpolate` (render.c:912)
    accel_fft: bool = True             # `setaccelfft` (render.c:927)
    smooth_pass: bool = True           # `setsmoothpass` (render.c:929)
    smooth_factor: float = 0.025       # `setsmoothfactor` (render.c:916)
    smooth_distance: float = 0.01      # `setsmooth` (render.c:917)
    smooth_ratio: float = 4.0          # `setsmoothratio` (render.c:918)

    # --- frame loop -----------------------------------------------------
    framerate: int = 0                 # `setframerate` (0 = uncapped)
    swap: int = 1                      # `setswap` (vsync interval)
    print_frames: bool = True          # `setprintframes` (render.c:907)
    timecycle: float = 60.0            # `timecycle` (render.c:904)
    fullscreen_check: bool = False     # `setfullscreencheck`

    # --- presentation hints (window-capability parity) ------------------
    geometry: tuple[int, int, int, int] = (0, 0, 500, 400)  # `setgeometry`
    clear_color: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    opacity: str = "native"            # `setopacity`: native|xroot|none
    premultiply_alpha: bool = True     # derived from opacity (render.c:1038)
    copy_desktop: bool = True          # raw default render.c:924; normalized
                                       # by any `setopacity` (render.c:1042-1045)
    background_image: str | None = None  # `setbgimg` (extension): the
    #                                    xroot composite source — plays the
    #                                    role of the root-pixmap wallpaper
    #                                    copy (xwin.c:345-472), sampled at
    #                                    the window geometry
    title: str = "GLava"               # `settitle`
    decorated: bool = True             # `setdecorated`
    floating: bool = False             # `setfloating`
    focused: bool = False              # `setfocused`
    maximized: bool = False            # `setmaximized`
    clickthrough: bool = False         # `setclickthrough`
    force_geometry: bool = False       # `setforcegeometry` (deprecated)
    force_raised: bool = False         # `setforceraised` (deprecated)
    xwintype: str | None = None        # `setxwintype`
    xwinstates: list[str] = field(default_factory=list)  # `addxwinstate`

    # --- test / debug -----------------------------------------------------
    test_eval_color: tuple[float, float, float, float] | None = None  # `settesteval`

    # --- bookkeeping for loader semantics -------------------------------
    # `mod` requests are only honored while loading the entry file
    # (render.c:1102 `loading_module`); smoothing knobs are ignored while
    # (re)building the smooth-pass operator (`loading_smooth_pass`).
    loading_module: bool = True
    loading_smooth_pass: bool = False
    # `addxwinstate` is dropped in --desktop mode unless presets are
    # loading (render.c:1143).
    auto_desktop: bool = False
    loading_presets: bool = False

    def copy(self) -> "RenderConfig":
        return dataclasses.replace(self, xwinstates=list(self.xwinstates))

    @property
    def scaled_bufsize(self) -> int:
        """Buffer length after `setbufscale` decimation — the spectrum
        texture size (render.c:1765-1790)."""
        return self.bufsize // self.bufscale if self.bufscale > 1 else self.bufsize

    @property
    def hop(self) -> int:
        """Ring advance per audio update, in frames per channel.

        Both capture backends shift their rings by ``samplesize / 4``
        samples per read (fifo.c:91-92, pulse_input.c:155-156).
        """
        return max(self.samplesize // 4, 1)

    @property
    def nominal_ups(self) -> float:
        """Updates per second implied by rate and hop (rc.glsl:160-168:
        22050 Hz @ samplesize 1024 -> 86.1 UPS = 22050/256).

        The reference measures UPS at runtime and feeds it into the
        gravity step (render.c:728); under jit we use the deterministic
        nominal rate, optionally overridden by a traced measured value.
        """
        return self.sample_rate / self.hop

    @property
    def use_alpha(self) -> bool:
        return self.opacity == "native"

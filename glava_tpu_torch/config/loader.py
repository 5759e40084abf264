"""Configuration loading — the rd_new config phase, evaluated.

Mirrors the reference's load order (glava/render.c:1318-1435):

1. locate the entry file (user config root first, then the system
   shader root — glava.c:294-301, render.c:1327-1350) and execute its
   ``#request`` directives (``mod`` honored only here);
2. with ``--desktop``, overlay the ``env_<WM>.glsl`` preset (user copy
   preferred, else system; unknown WM falls back to env_default —
   render.c:1369-1410);
3. replay CLI ``-r`` requests as synthetic sources (render.c:1415-1435);
4. load the selected module's knob files and shared smoothing
   parameters — whose ``#request``s execute *after* everything above,
   exactly like the reference's per-pass ``#include`` processing
   (bars/1.frag:9-10 + util/smooth.glsl:6-7).

The result bundles the final :class:`RenderConfig` with the knob
environment the rasterizer modules evaluate their ``#define``s in.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from glava_tpu_torch.config import preprocessor, requests
from glava_tpu_torch.config.glsl_expr import Env
from glava_tpu_torch.config.state import RenderConfig

# the shipped shader files are data of the JAX package; read them by
# path (importing glava_tpu would import jax)
SYSTEM_SHADER_DIR = (
    Path(__file__).resolve().parents[2] / "glava_tpu" / "data" / "shaders"
)

PI = 3.14159265359
TWOPI = 6.28318530718


@dataclass
class LoadedConfig:
    cfg: RenderConfig
    env: Env
    entry_path: Path
    module: str
    defines: dict[str, str] = field(default_factory=dict)
    # user GLSL shader modules this load registered: name -> (builder,
    # uniforms), shadowing built-ins of the same name
    module_overrides: dict = field(default_factory=dict)


def _dispatcher(cfg: RenderConfig):
    def on_request(name: str, args: list[str], fname: str, line: int) -> None:
        try:
            requests.execute(cfg, name, args)
        except requests.RequestError as e:
            raise requests.RequestError(f"[{fname}:{line}] {e}") from None

    return on_request


def _find(name: str, user_dir: Path | None, system_dir: Path) -> Path | None:
    if user_dir is not None and (user_dir / name).is_file():
        return user_dir / name
    if (system_dir / name).is_file():
        return system_dir / name
    return None


def load(
    entry: str = "rc.glsl",
    *,
    user_dir: str | Path | None = None,
    system_dir: str | Path = SYSTEM_SHADER_DIR,
    cli_requests: tuple[str, ...] = (),
    force_module: str | None = None,
    desktop: bool = False,
    wm_name: str | None = None,
    pipe_values: dict[str, Any] | None = None,
) -> LoadedConfig:
    system_dir = Path(system_dir)
    user_dir = Path(user_dir) if user_dir is not None else None

    cfg = RenderConfig()
    cfg.auto_desktop = desktop
    on_request = _dispatcher(cfg)
    ctx = preprocessor.Context(
        system_dir=system_dir, user_dir=user_dir, on_request=on_request
    )

    # 1. entry
    entry_path = _find(entry, user_dir, system_dir)
    if entry_path is None:
        raise FileNotFoundError(
            f"could not find entry file '{entry}' in "
            f"{[str(p) for p in (user_dir, system_dir) if p]}"
        )
    cfg.loading_module = True
    preprocessor.process_file(entry_path, ctx)
    cfg.loading_module = False

    # 2. desktop env presets
    if desktop:
        preset = f"env_{wm_name}.glsl" if wm_name else None
        path = _find(preset, user_dir, system_dir) if preset else None
        if path is None:
            path = _find("env_default.glsl", user_dir, system_dir)
        if path is not None:
            cfg.loading_presets = True
            preprocessor.process_file(path, ctx)
            cfg.loading_presets = False

    # 3. CLI requests, evaluated like the directive itself
    for req in cli_requests:
        args = preprocessor.tokenize_args(req)
        if args:
            on_request(args[0], args[1:], "<request>", 0)

    # 4. user Python modules + drop-in GLSL shader modules (the
    # reference scans config-root module dirs, render.c:1488-1597), then
    # module knobs + smoothing params. Registrations are captured into
    # this load's override map, not left in the global registry; a
    # shader module shadows a Python module of the same name.
    module_overrides: dict = {}
    if user_dir is not None:
        from glava_tpu_torch.render.modules import _REGISTRY, load_user_modules
        from glava_tpu_torch.render.modules.glsl_module import (
            register_shader_module,
            scan_shader_modules,
        )

        snapshot = dict(_REGISTRY)
        try:
            load_user_modules(user_dir)
            for k, v in _REGISTRY.items():
                if snapshot.get(k) is not v:
                    module_overrides[k] = v
        finally:
            _REGISTRY.clear()
            _REGISTRY.update(snapshot)
        for mname, mdir in scan_shader_modules(user_dir).items():
            register_shader_module(mname, mdir, user_dir, system_dir,
                                   registry=module_overrides)
    if force_module:
        cfg.module = force_module
    module = cfg.module
    for name in ("smooth_parameters.glsl", f"{module}.glsl"):
        sys_p = system_dir / name
        if sys_p.is_file():  # '@' include
            preprocessor.process_file(sys_p, ctx)
        usr_p = user_dir / name if user_dir else None
        if usr_p is not None and usr_p.is_file():  # ':' include
            preprocessor.process_file(usr_p, ctx)

    env = Env(
        defines=dict(ctx.defines),
        variables=builtin_variables(cfg),
        pipe_values=dict(pipe_values or {}),
    )
    return LoadedConfig(
        cfg=cfg, env=env, entry_path=entry_path, module=module,
        defines=dict(ctx.defines), module_overrides=module_overrides,
    )


def builtin_variables(cfg: RenderConfig) -> dict[str, Any]:
    """The implicit macro environment every pass sees.

    PI/TWOPI come from util/common.glsl / per-pass defines; the
    underscore names are the synthesized shader header
    (render.c:283-291 EBINDs + _SMOOTH_FACTOR at render.c:320).
    """
    return {
        "PI": PI,
        "TWOPI": TWOPI,
        "_AVG_FRAMES": float(cfg.avg_frames),
        "_AVG_WINDOW": float(cfg.avg_window),
        "_USE_ALPHA": 1.0,  # baked to 1 in the reference (render.c:287)
        "_PREMULTIPLY_ALPHA": 1.0 if cfg.premultiply_alpha else 0.0,
        "_CHANNELS": 1.0 if cfg.mirror_input else 2.0,
        "_PRE_SMOOTHED_AUDIO": 1.0 if cfg.smooth_pass else 0.0,
        # reference: glGetIntegerv(GL_MAX_FRAGMENT_UNIFORM_COMPONENTS)
        # (render.c:246-247, EBIND render.c:290); no GL limit applies
        # here, so expose the common desktop-GL value
        "_UNIFORM_LIMIT": 4096.0,
        "_SMOOTH_FACTOR": cfg.smooth_factor,
    }

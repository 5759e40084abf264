"""Drop-in GLSL shader modules, interpreted.

GLava's user-extension workflow (render.c:1488-1597): a config root
directory ``<name>/`` holding ``1.frag, 2.frag, ...`` becomes module
``<name>``. Each pass runs through the restricted-GLSL interpreter
(``config/glsl_shader.py``) as a vectorized torch program over the
(H, W) pixel grid, re-run every frame. The config loader discovers and
registers these modules into the load's own override map, so a user's
shader directory shadows a built-in module of the same name, like the
reference's user-over-system path search.

On a mesh's rows axis a shader module does not take its band
(``ModuleBuild.banded`` stays False): the interpreter's fetch routes
(constant shifts, first-hit walks through the latch scan, run-time rows
through the row-wise lookup) read ``prev`` at any row over the whole
pixel grid, so every pass renders the whole frame on each device of a
row group and the renderer keeps the band (counted in
``renderer.whole_frame_bands``). Its frames are right; the module gets
no split of its work.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from glava_tpu_torch.config import glsl_expr, glsl_shader, preprocessor
from glava_tpu_torch.config.glsl_shader import (
    ParsedShader,
    ShaderError,
    _Exec,
    _fetch_1d,
    make_builtins,
    parse_declarations,
    parse_shader,
)
from glava_tpu_torch.ops import smoothing
from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import _REGISTRY
from glava_tpu_torch.utils import profiling

TWOPI = 6.28318530718
PI = 3.14159265359

_SCALAR_SOURCES = {"screen", "audio_sz", "time", "prev"}


def _pass_files(mod_dir: Path) -> list[Path]:
    files = []
    n = 1
    while (mod_dir / f"{n}.frag").is_file():
        files.append(mod_dir / f"{n}.frag")
        n += 1
    return files


def scan_shader_modules(user_dir) -> dict[str, Path]:
    """Find ``<user_dir>/<name>/1.frag`` module directories."""
    out: dict[str, Path] = {}
    if user_dir is None:
        return out
    root = Path(user_dir)
    if not root.is_dir():
        return out
    for d in sorted(root.iterdir()):
        if d.is_dir() and d.name not in ("modules", "profiles", "util") \
                and (d / "1.frag").is_file():
            out[d.name] = d
    return out


def _collect_uniforms(files: list[Path]):
    """Uniform/transform declarations across all passes -> uniform
    declarations ``(name, source, transforms)`` for the audio pipeline
    + the per-pass parsed declarations."""
    audio_uniforms: dict[str, tuple[str, tuple[str, ...]]] = {}
    per_pass: list[ParsedShader] = []
    for f in files:
        parsed = parse_declarations(f.read_text())
        per_pass.append(parsed)
        for src, name in parsed.uniforms:
            if src in ("audio_l", "audio_r"):
                chain = tuple(parsed.transforms.get(name, ()))
                prev_entry = audio_uniforms.get(name)
                if prev_entry is None or (not prev_entry[1] and chain):
                    audio_uniforms[name] = (src, chain)
            elif src not in _SCALAR_SOURCES:
                raise ShaderError(f"unknown uniform source '{src}'")
    # a declared uniform without `#request transform` lines receives
    # the raw (untransformed) ring, exactly like the reference
    specs = tuple(
        (name, src, chain) for name, (src, chain) in audio_uniforms.items()
    )
    return specs, per_pass


def register_shader_module(name: str, mod_dir: Path, user_dir, system_dir,
                           registry: dict | None = None) -> None:
    """Register module ``name`` (the passes in ``mod_dir``) into
    ``registry`` (the global module registry by default)."""
    files = _pass_files(mod_dir)
    if not files:
        raise ShaderError(f"module dir '{mod_dir}' has no 1.frag")
    uniforms, _ = _collect_uniforms(files)

    def builder(ctx: base.ModuleContext) -> base.ModuleBuild:
        return _build(name, files, ctx, user_dir, system_dir)

    (_REGISTRY if registry is None else registry)[name] = (builder, uniforms)


def _per_pixel_sampler(ctx: base.ModuleContext):
    """smooth_audio at per-pixel positions, for the GLSL interpreter.

    With the default smooth pass the fetch is exact
    (tex[round(pos*sz)], smooth.glsl:62). Without it, the presmoothed
    texture is sampled: output positions differ from texel centers by
    < 1/sz (the JAX package's documented deviation; the reference
    default has the smooth pass on).
    """
    sz = ctx.sz

    def indices(pos):
        """Texel indices for ``pos``, keeping host-known positions
        numpy: f32 multiply, round half to even, int cast (the clip
        happens in _fetch_1d either way)."""
        if isinstance(pos, (np.ndarray, np.generic, int, float)):
            p32 = np.asarray(pos).astype(np.float32)
            return np.round(p32 * np.float32(sz)).astype(np.int32)
        return torch.round(pos * sz).to(torch.int32)

    def sample(tex, i):
        """tex[i], exploiting a host-known plane's structure: an
        axis-constant (H, W) plane (bars/graph sample by column only)
        fetches ONE axis of points and broadcasts."""
        if isinstance(i, np.ndarray) and i.ndim == 2:
            h2, w2 = i.shape
            if np.array_equal(i, np.broadcast_to(i[0:1, :], i.shape)):
                return _fetch_1d(tex, i[0], sz)[None, :].expand(h2, w2)
            if np.array_equal(i, np.broadcast_to(i[:, 0:1], i.shape)):
                return _fetch_1d(tex, i[:, 0], sz)[:, None].expand(h2, w2)
        return _fetch_1d(tex, i, sz)

    if ctx.cfg.smooth_pass:
        def fetch(tex, pos):
            return sample(tex, indices(pos))
        return fetch
    op = smoothing.presmooth_op(sz, ctx.smooth_params).on(ctx.device)

    def fetch(tex, pos):
        return sample(op(tex), indices(pos))

    return fetch


def _build(name: str, files: list[Path], ctx: base.ModuleContext,
           user_dir, system_dir) -> base.ModuleBuild:
    w, h = ctx.screen
    sz = ctx.sz
    dev = ctx.device
    passes = []

    fetch = _per_pixel_sampler(ctx)

    for f in files:
        raw = f.read_text()
        parsed = parse_declarations(raw)
        # collect uniform declarations made during preprocessing too:
        # included files may bind uniforms (e.g. util/premultiply.frag
        # binds `prev`); other requests are frozen at this point
        reqs: list[tuple[str, list[str]]] = []
        pctx = preprocessor.Context(
            system_dir=Path(system_dir) if system_dir else None,
            user_dir=Path(user_dir) if user_dir else None,
            on_request=lambda n, a, _f, _l: reqs.append((n, list(a))),
            defines=dict(ctx.env.defines),
        )
        # builtin macro environment (_CHANNELS etc.) for #if evaluation
        for k, v in ctx.env.variables.items():
            if isinstance(v, (int, float)) and k not in pctx.defines:
                pctx.defines[k] = repr(v)
        srcmap: list = []
        try:
            text = preprocessor.preprocess_shader_source(
                raw, pctx, fname=str(f), current_dir=f.parent,
                srcmap=srcmap,
            )
        except preprocessor.StageDisabledDirective:
            continue
        program = parse_shader(text, fname=str(f), srcmap=srcmap)
        seen = set()
        uniforms = []
        for n, a in reqs:
            if n == "uniform" and len(a) >= 2 and a[1] not in seen:
                uniforms.append((a[0], a[1]))
                seen.add(a[1])
        for src, uname in parsed.uniforms:
            if uname not in seen:
                uniforms.append((src, uname))
                seen.add(uname)
        parsed.uniforms = uniforms

        xs, ys = base.frag_coords(w, h, parsed.pixel_center_integer)
        # host numpy, not tensors: coordinate math stays numpy until it
        # meets runtime data, so the fetch routes can read its structure
        x2d = xs.astype(np.float32)[None, :]
        y2d = ys.astype(np.float32)[:, None]
        defines = dict(pctx.defines)

        def make_pass(program=program, parsed=parsed, defines=defines,
                      x2d=x2d, y2d=y2d):
            def pass_fn(inputs: base.PassInputs):
                # a span a pass (utils/profiling.py)
                ts = profiling.begin()
                out = run_pass(inputs)
                if ts:
                    profiling.end("shader.pass", ts)
                return out

            def run_pass(inputs: base.PassInputs):
                variables = dict(ctx.env.variables)
                for src, uname in parsed.uniforms:
                    if src in ("audio_l", "audio_r"):
                        variables[uname] = inputs.textures[uname]
                    elif src == "screen":
                        variables[uname] = (float(w), float(h))
                    elif src == "audio_sz":
                        variables[uname] = float(sz)
                    elif src == "time":
                        # a device float32 scalar, as the JAX step's
                        # traced argument (a compiled step's input)
                        variables[uname] = base.f32_tensor(inputs.time,
                                                           dev)
                    elif src == "prev":
                        variables[uname] = "prev"
                variables.update({
                    "gl_FragCoord": (x2d, y2d, 0.0, 1.0),
                    "PI": PI, "TWOPI": TWOPI,
                    "fragment": (0.0, 0.0, 0.0, 0.0),
                })
                builtins = make_builtins(inputs.prev, sz, h, w, fetch, dev)
                env = glsl_expr.Env(
                    defines=defines,
                    variables=variables,
                    pipe_values=ctx.env.pipe_values,
                    functions=builtins,
                )
                ex = _Exec(env, h, w, dev)
                ex.src_info = (program.fname, program.srcmap)
                try:
                    # GLSL arithmetic never warns (inf/nan propagate,
                    # GPU-style); the numpy paths would otherwise emit
                    # RuntimeWarnings, e.g. for a polar center pixel
                    with np.errstate(all="ignore"):
                        ex.bind_structs(program.structs)
                        ex.bind_functions(program.funcs)
                        ex.run(program.pre_body)
                        ex.run(program.body)
                    frag = env.variables.get("fragment",
                                             (0.0, 0.0, 0.0, 0.0))
                finally:
                    # release this pass's planes and provenance
                    if glsl_shader._CURRENT_EXEC is ex:
                        glsl_shader._CURRENT_EXEC = None
                # channel planes out; numpy (host-known) channels stay
                # numpy across the pass boundary
                return base.as_planes(
                    frag if isinstance(frag, tuple) else (frag,) * 4
                )

            return pass_fn

        passes.append(make_pass())

    if not passes:
        raise ShaderError(f"module '{name}': every pass disabled")
    return base.ModuleBuild(name, passes, kind="shader")

"""Command-line entry point of the port, flag-compatible with the JAX
package's CLI (-v -d -r -m -e -C -a -p/--pipe -i/--stdin -T
--config-dir --sink --frames --seconds --size --offline --fps), plus
``--device``.

    python -m glava_tpu_torch --audio synth --frames 300 --sink null
    echo 'fg = #00ff00' | python -m glava_tpu_torch -a synth -p fg --frames 60
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import sys
from pathlib import Path

from glava_tpu_torch import __version__
from glava_tpu_torch.config.loader import SYSTEM_SHADER_DIR
from glava_tpu_torch.runtime import audio as audio_mod
from glava_tpu_torch.runtime.engine import Engine, EngineOptions
from glava_tpu_torch.runtime.sinks import make_sink
from glava_tpu_torch.runtime.stdin_pipe import VALID_TYPES, PipeBind

USER_CONFIG_DIRS = ("~/.config/glava_tpu", "~/.config/glava")


def default_user_dir() -> str | None:
    for d in USER_CONFIG_DIRS:
        p = Path(os.path.expanduser(d))
        if p.is_dir():
            return str(p)
    return None


def copy_config(verbose: bool) -> int:
    """--copy-config: install user-editable copies (glava.c:85-167)."""
    dst = Path(os.path.expanduser(USER_CONFIG_DIRS[0]))
    dst.mkdir(parents=True, exist_ok=True)
    for f in sorted(SYSTEM_SHADER_DIR.glob("*.glsl")):
        target = dst / f.name
        if target.exists():
            if verbose:
                print(f"skipping '{target}' (exists)")
            continue
        shutil.copyfile(f, target)
        if verbose:
            print(f"copied '{f}' -> '{target}'")
    print(f"installed user configuration in {dst}")
    return 0


def parse_pipe(spec: str | None) -> PipeBind:
    if not spec:
        raise argparse.ArgumentTypeError("--pipe needs BIND[:TYPE]")
    name, _, stype = spec.partition(":")
    stype = stype or "vec4"
    if stype not in VALID_TYPES:
        raise argparse.ArgumentTypeError(
            f"invalid --pipe type '{stype}' (expected one of {VALID_TYPES})"
        )
    return PipeBind(name, stype)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="glava-tpu-torch",
        description="Audio spectrum visualizer (GLava-compatible "
        "configuration) on PyTorch and CUDA.",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-d", "--desktop", action="store_true",
                   help="desktop-widget mode: apply env_<WM>.glsl presets")
    p.add_argument("-r", "--request", action="append", default=[],
                   metavar="REQUEST", help="evaluate a #request after rc.glsl")
    p.add_argument("-m", "--force-mod", metavar="NAME",
                   help="force a module, overriding `#request mod`")
    p.add_argument("-e", "--entry", default="rc.glsl", metavar="FILE")
    p.add_argument("-C", "--copy-config", action="store_true",
                   help="install the shipped configuration files into "
                        "~/.config/glava_tpu (existing files are kept)")
    p.add_argument("-a", "--audio", default=None, metavar="BACKEND",
                   help=f"audio backend ({', '.join(audio_mod.available())}; "
                        "default pulseaudio when `parec` is on the PATH, "
                        "else synth)")
    p.add_argument("-p", "--pipe", action="append", default=[],
                   metavar="BIND[:TYPE]", type=parse_pipe,
                   help="bind a live uniform read from stdin as "
                        "`name = value` lines (TYPE: int, float, bool, "
                        "vec2, vec3, vec4 (default))")
    p.add_argument("-i", "--stdin", nargs="?", const="vec4", default=None,
                   metavar="TYPE",
                   help="legacy: read bare values from stdin into the "
                        "STDIN uniform (default type vec4)")
    p.add_argument("-V", "--version", action="version",
                   version=f"glava-tpu-torch {__version__}")
    p.add_argument("-T", "--run-tests", action="store_true",
                   help="golden-frame test mode (render one frame, assert "
                        "`settesteval` color)")
    p.add_argument("--config-dir", default=None,
                   help="user configuration root (default: ~/.config/glava_tpu)")
    p.add_argument("--sink", default="latest", metavar="SPEC",
                   help="frame sink: null | latest | raw[:path] | y4m[:path] "
                        "| png:path")
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames")
    p.add_argument("--seconds", type=float, default=None,
                   help="stop after N seconds")
    p.add_argument("--size", default=None, metavar="WxH",
                   help="output size override")
    p.add_argument("--offline", action="store_true",
                   help="render a recorded track faster than realtime "
                        "(requires -a wav with setsource)")
    p.add_argument("--fps", type=float, default=60.0,
                   help="output frame rate for --offline (default 60)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.copy_config:
        return copy_config(args.verbose)

    screen = None
    if args.size:
        w, _, h = args.size.partition("x")
        screen = (int(w), int(h))

    backend = args.audio
    if backend is None:
        backend = "pulseaudio" if shutil.which("parec") else "synth"
        if args.verbose:
            print(f"Using audio backend: '{backend}'")

    pipe_binds = list(args.pipe)
    if args.stdin:
        if args.stdin not in VALID_TYPES:
            print(f"invalid --stdin type '{args.stdin}'", file=sys.stderr)
            return 2
        pipe_binds.append(PipeBind("STDIN", args.stdin))

    opts = EngineOptions(
        entry=args.entry,
        user_dir=args.config_dir or default_user_dir(),
        requests=tuple(args.request),
        force_module=args.force_mod,
        desktop=args.desktop,
        wm_name=os.environ.get("XDG_CURRENT_DESKTOP"),
        audio_backend=backend,
        screen=screen,
        pipe_binds=tuple(pipe_binds),
        test_mode=args.run_tests,
        verbose=args.verbose,
        device=args.device,
    )
    sink = make_sink(args.sink, fps=args.fps)

    if args.offline:
        if backend != "wav":
            print("--offline requires `-a wav` with setsource", file=sys.stderr)
            return 2
        from glava_tpu_torch.config import loader
        from glava_tpu_torch.runtime.offline import render_wav

        lc = loader.load(
            entry=opts.entry, user_dir=opts.user_dir,
            cli_requests=opts.requests, force_module=opts.force_module,
            desktop=opts.desktop, wm_name=opts.wm_name,
        )
        if not lc.cfg.audio_source or lc.cfg.audio_source == "auto":
            print("--offline needs `setsource \"/path.wav\"`", file=sys.stderr)
            return 2
        n = render_wav(lc, lc.cfg.audio_source, sink, fps=args.fps,
                       screen=screen, verbose=True, device=args.device)
        sink.close()
        return 0 if n > 0 else 1

    engine = Engine(opts, sink=sink,
                    pipe_stream=sys.stdin if pipe_binds else None)

    # SIGTERM/SIGINT -> terminate; SIGUSR1 -> reload (glava-cli/cli.c:7-15)
    signal.signal(signal.SIGTERM, lambda *_: engine.terminate())
    signal.signal(signal.SIGINT, lambda *_: engine.terminate())
    if hasattr(signal, "SIGUSR1"):
        signal.signal(signal.SIGUSR1, lambda *_: engine.reload())

    if args.run_tests:
        ok = engine.run_tests()
        print("test evaluation: " + ("PASSED" if ok else "FAILED"))
        return 0 if ok else 1

    engine.run(max_frames=args.frames, max_seconds=args.seconds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

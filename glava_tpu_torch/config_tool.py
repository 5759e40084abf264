"""Configuration inspector/editor — the glava-config capability as a CLI.

The port's copy of ``glava_tpu/config_tool.py``, on the port's config
loader, request table and module registry (it imports neither jax nor
glava_tpu), installed as ``glava-tpu-torch-config``
(``python -m glava_tpu_torch.config_tool``).

The reference ships an (unfinished) GTK3/Lua configuration GUI
(glava-config/: module discovery at main.lua:47-54, option->widget
mappings, profile management + a GLSL-config pattern parser at
config.lua:47-60). The same capabilities here, scriptable:

    glava-tpu-torch-config modules                 # discover modules
    glava-tpu-torch-config knobs bars              # knob names, values, docs
    glava-tpu-torch-config requests                # the #request schema
    glava-tpu-torch-config show                    # resolved RenderConfig
    glava-tpu-torch-config set bars BAR_WIDTH 8    # edit a user knob override
    glava-tpu-torch-config get bars BAR_WIDTH
    glava-tpu-torch-config profile list|new|copy   # named config profiles
    glava-tpu-torch-config install                 # --copy-config equivalent

Profiles are directories under the user config root; select one at
runtime with ``glava-tpu-torch --config-dir``.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys
from pathlib import Path

from glava_tpu_torch.config import loader, requests
from glava_tpu_torch.config.loader import SYSTEM_SHADER_DIR
from glava_tpu_torch.render import modules as render_modules


def user_root(args) -> Path:
    from glava_tpu_torch.cli import USER_CONFIG_DIRS, default_user_dir

    if args.config_dir:
        return Path(args.config_dir)
    d = default_user_dir()
    if d:
        return Path(d)
    return Path(os.path.expanduser(USER_CONFIG_DIRS[0]))


def _knob_docs(path: Path) -> dict[str, tuple[str, str]]:
    """Parse `#define NAME VALUE` entries with their preceding comments."""
    out: dict[str, tuple[str, str]] = {}
    if not path.is_file():
        return out
    doc: list[str] = []
    for line in path.read_text().splitlines():
        s = line.strip()
        m = re.match(r"/\*\s*(.*?)\s*\*/\s*$", s)
        if m:
            doc.append(m.group(1))
            continue
        m = re.match(r"#define\s+(\w+)\s+(.*?)\s*$", s)
        if m:
            out[m.group(1)] = (m.group(2), " ".join(doc))
            doc = []
            continue
        if s and not s.startswith(("/*", "*", "//")):
            doc = []
    return out


def cmd_modules(args) -> int:
    print("available modules:")
    for name in render_modules.available():
        marker = " (test fixture)" if name == "test" else ""
        print(f"  {name}{marker}")
    root = user_root(args)
    if root.is_dir():
        from glava_tpu_torch.render.modules.glsl_module import scan_shader_modules

        shader_mods = scan_shader_modules(root)
        py_dir = root / "modules"
        py_mods = sorted(p.stem for p in py_dir.glob("*.py")) \
            if py_dir.is_dir() else []
        for name in sorted(shader_mods):
            print(f"  {name} (user GLSL, {shader_mods[name]})")
        for name in py_mods:
            print(f"  {name} (user Python, {py_dir / (name + '.py')}; a "
                  "JAX program, which this package does not run)")
    return 0


def cmd_knobs(args) -> int:
    sys_docs = _knob_docs(SYSTEM_SHADER_DIR / f"{args.module}.glsl")
    usr_path = user_root(args) / f"{args.module}.glsl"
    usr_docs = _knob_docs(usr_path)
    if not sys_docs and not usr_docs:
        print(f"no knob file for module '{args.module}'", file=sys.stderr)
        return 1
    names = list(dict.fromkeys([*sys_docs, *usr_docs]))
    for n in names:
        val, doc = usr_docs.get(n) or sys_docs[n]
        origin = "user" if n in usr_docs else "default"
        print(f"{n} = {val}   [{origin}]")
        if doc:
            print(f"    {doc}")
    return 0


def cmd_requests(args) -> int:
    fmt_names = {"b": "bool", "i": "int", "f": "float", "s": "string"}
    for name, (fmt, _) in sorted(requests.HANDLERS.items()):
        sig = " ".join(fmt_names[c] for c in fmt)
        print(f"#request {name} {sig}")
    print("#request transform <uniform> <name>   (module context)")
    print("#request uniform <source> <name>      (module context)")
    return 0


def cmd_show(args) -> int:
    lc = loader.load(user_dir=str(user_root(args))
                     if user_root(args).is_dir() else None)
    import dataclasses

    for f in dataclasses.fields(lc.cfg):
        if f.name in ("loading_module", "loading_smooth_pass",
                      "auto_desktop", "loading_presets"):
            continue
        print(f"{f.name} = {getattr(lc.cfg, f.name)}")
    return 0


def cmd_get(args) -> int:
    for root in (user_root(args), SYSTEM_SHADER_DIR):
        docs = _knob_docs(root / f"{args.module}.glsl")
        if args.name in docs:
            print(docs[args.name][0])
            return 0
    print(f"knob '{args.name}' not found in module '{args.module}'",
          file=sys.stderr)
    return 1


def cmd_set(args) -> int:
    root = user_root(args)
    root.mkdir(parents=True, exist_ok=True)
    path = root / f"{args.module}.glsl"
    lines = path.read_text().splitlines() if path.is_file() else []
    pat = re.compile(rf"^(\s*#define\s+{re.escape(args.name)}\s+).*$")
    for i, line in enumerate(lines):
        if pat.match(line):
            lines[i] = f"#define {args.name} {args.value}"
            break
    else:
        lines.append(f"#define {args.name} {args.value}")
    path.write_text("\n".join(lines) + "\n")
    print(f"set {args.name} = {args.value} in {path}")
    return 0


def cmd_profile(args) -> int:
    root = user_root(args)
    profiles = root / "profiles"
    if args.action == "list":
        if profiles.is_dir():
            for p in sorted(profiles.iterdir()):
                if p.is_dir():
                    print(p.name)
        return 0
    if not args.name:
        print("profile name required", file=sys.stderr)
        return 1
    target = profiles / args.name
    if args.action == "new":
        target.mkdir(parents=True, exist_ok=True)
        for f in sorted(SYSTEM_SHADER_DIR.glob("*.glsl")):
            if not (target / f.name).exists():
                shutil.copyfile(f, target / f.name)
        print(f"profile '{args.name}' created at {target}")
        print(f"use it with: glava-tpu-torch --config-dir {target}")
        return 0
    if args.action == "copy":
        target.mkdir(parents=True, exist_ok=True)
        for f in sorted(root.glob("*.glsl")):
            shutil.copyfile(f, target / f.name)
        print(f"profile '{args.name}' copied from {root}")
        return 0
    print(f"unknown profile action '{args.action}'", file=sys.stderr)
    return 1


def cmd_install(args) -> int:
    from glava_tpu_torch.cli import copy_config

    return copy_config(verbose=True)


def cmd_interactive(args, stdin=None) -> int:
    """Interactive editing session — the capability the reference's
    GTK GUI aims at (glava-config/main.lua:47-54's module browser +
    option editing), as a terminal session over the same engine as
    the scriptable subcommands.

        $ glava-tpu-torch-config interactive
        glava-config> use bars
        glava-config bars> knobs
        glava-config bars> set BAR_WIDTH 8
        glava-config bars> quit

    Reads EOF as quit, so it is scriptable too (pipe a command list).
    """
    stdin = stdin if stdin is not None else sys.stdin
    tty = hasattr(stdin, "isatty") and stdin.isatty()
    module = None
    cfgflag = ["--config-dir", args.config_dir] if args.config_dir else []

    def emit_prompt():
        if tty:
            mod = f" {module}" if module else ""
            print(f"glava-config{mod}> ", end="", flush=True)

    print("glava-tpu-torch interactive config — 'help' lists commands, "
          "'quit' exits.")
    emit_prompt()
    for line in stdin:
        parts = line.split()
        if not parts:
            emit_prompt()
            continue
        cmd, rest = parts[0], parts[1:]
        try:
            if cmd in ("quit", "exit", "q"):
                break
            elif cmd == "help":
                print("commands: modules | use <module> | knobs [module]"
                      " | get <KNOB> | set <KNOB> <value> | requests"
                      " | show | profile list|new|copy [name]"
                      " | install | quit")
            elif cmd == "use":
                if not rest:
                    print("usage: use <module>", file=sys.stderr)
                else:
                    module = rest[0]
                    print(f"module: {module}")
            elif cmd in ("modules", "requests", "show", "install"):
                main(cfgflag + [cmd])
            elif cmd == "knobs":
                target = rest[0] if rest else module
                if not target:
                    print("no module selected — 'use <module>' first",
                          file=sys.stderr)
                else:
                    main(cfgflag + ["knobs", target])
            elif cmd in ("get", "set"):
                if not module:
                    print("no module selected — 'use <module>' first",
                          file=sys.stderr)
                elif (cmd == "get" and len(rest) != 1) or \
                        (cmd == "set" and len(rest) != 2):
                    print(f"usage: {cmd} <KNOB>"
                          + (" <value>" if cmd == "set" else ""),
                          file=sys.stderr)
                else:
                    main(cfgflag + [cmd, module, *rest])
            elif cmd == "profile":
                main(cfgflag + ["profile", *rest])
            else:
                print(f"unknown command '{cmd}' — try 'help'",
                      file=sys.stderr)
        except SystemExit:
            pass  # argparse errors inside a session must not kill it
        emit_prompt()
    if tty:
        print()
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="glava-tpu-torch-config")
    p.add_argument("--config-dir", default=None)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("modules").set_defaults(fn=cmd_modules)
    k = sub.add_parser("knobs")
    k.add_argument("module")
    k.set_defaults(fn=cmd_knobs)
    sub.add_parser("requests").set_defaults(fn=cmd_requests)
    sub.add_parser("show").set_defaults(fn=cmd_show)
    g = sub.add_parser("get")
    g.add_argument("module")
    g.add_argument("name")
    g.set_defaults(fn=cmd_get)
    s = sub.add_parser("set")
    s.add_argument("module")
    s.add_argument("name")
    s.add_argument("value")
    s.set_defaults(fn=cmd_set)
    pr = sub.add_parser("profile")
    pr.add_argument("action", choices=("list", "new", "copy"))
    pr.add_argument("name", nargs="?")
    pr.set_defaults(fn=cmd_profile)
    sub.add_parser("install").set_defaults(fn=cmd_install)
    sub.add_parser("interactive").set_defaults(fn=cmd_interactive)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

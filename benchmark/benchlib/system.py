"""What every driver (``drivers/<name>.py``) gives the run: the system
under test built from a configuration and a traffic mix, its sinks and
devices, and the program's spectrum state after the window."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class System:
    """A system under test. ``devices``: the torch devices it uses;
    ``sinks``: one :class:`benchlib.live.StampSink` a stream; ``modules``
    and ``pipe`` (name -> (S, 4)): each stream's module and pipe values;
    ``blocks``: each device's streams as (start, stop); ``shapes``: what
    the rooflines count (``n``, ``F``, ``H``, ``W``, and per device
    ``rows`` (the fft uniform rows its update holds), ``bars_streams``,
    ``color_rows``)."""

    devices: list
    sinks: list
    modules: list
    pipe: dict
    shapes: dict

    @property
    def blocks(self) -> list:
        return [(0, len(self.sinks))]

    def warm(self, seconds: float) -> None:
        raise NotImplementedError

    def window(self, seconds: float) -> None:
        raise NotImplementedError

    def state(self) -> dict:
        raise NotImplementedError

    def close(self) -> None:
        pass


def verify(config: dict, loadeds: list) -> None:
    """Raise unless the program loaded what the configuration file
    states: its ``dsp`` values and geometry, and every knob of its
    modules that the load defines (numbers by value, expressions by
    text)."""
    for lc in loadeds:
        cfg = lc.cfg
        for k, want in config["dsp"].items():
            got = getattr(cfg, k)
            if (got != want if isinstance(want, (bool, str))
                    else not np.isclose(float(got), float(want), rtol=1e-12)):
                raise ValueError(f"the program loaded {k} = {got!r}, the "
                                 f"configuration states {want!r}")
        if list(cfg.geometry[2:]) != list(config["geometry"]):
            raise ValueError(f"the program loaded geometry {cfg.geometry}, "
                             f"the configuration states {config['geometry']}")
        env = lc.env
        for k, want in config["knobs"][lc.module].items():
            if k in env.defines and isinstance(want, str):
                got = env.defines[k].strip()
            elif k in env.defines or k.startswith("_"):
                got = float(env.lookup(k))
                want = float(want)
            else:
                continue
            if got != want and not (isinstance(got, float)
                                    and np.isclose(got, want, rtol=1e-12)):
                raise ValueError(f"module {lc.module}: the program loaded "
                                 f"{k} = {got!r}, the configuration states "
                                 f"{want!r}")


class Row(NamedTuple):
    """One row of the program's spectrum state."""

    stream: int
    uniform: str        # the name its pipeline gives the fft uniform
    source: str         # the PCM it is fed from ("audio_l", "audio_r")
    chain: tuple        # its declared transforms


def bound_names(pipeline, module_uniforms: list) -> dict:
    """{name a module binds: the name of the pipeline's fft uniform that
    holds its row}: by name where the pipeline is the module's own, and
    otherwise by (source, transforms), as a fleet's union pipeline
    dedupes its variants' uniforms."""
    own = {u.name: u for u in pipeline.fft_uniforms}
    key = {(u.source, tuple(u.transforms)): u.name
           for u in pipeline.fft_uniforms}
    out = {}
    for u in module_uniforms:
        if own.get(u.name) == u:
            out[u.name] = u.name
        elif (u.source, tuple(u.transforms)) in key:
            out[u.name] = key[(u.source, tuple(u.transforms))]
    return out


def program_rows(parts: list) -> dict:
    """The program's spectrum state, every row it holds, in its own
    order: ``gravity`` and ``avg`` (R, 2 planes, m) float32 arrays;
    ``rows``, each row's :class:`Row`; ``binds``, each stream's {name
    its module binds: row}. ``parts``: (FusedChainState, its
    AudioPipeline, each of its streams' ``bound_names``) in stream
    order; a part's rows are ``s * U + u`` over the pipeline's fft
    uniforms."""
    out = {"gravity": [], "avg": [], "rows": [], "binds": []}
    for chains, pipeline, names in parts:
        fft = pipeline.fft_uniforms
        for name in ("gravity", "avg"):
            t = getattr(chains, name).detach().float().cpu().numpy()
            if len(t) != len(fft) * len(names):
                raise ValueError(f"the program holds {len(t)} rows, not "
                                 f"{len(fft)} uniforms x {len(names)} streams")
            out[name].append(t)
        for bound in names:
            s, base = len(out["binds"]), len(out["rows"])
            row = {u.name: base + i for i, u in enumerate(fft)}
            out["rows"] += [Row(s, u.name, u.source, tuple(u.transforms))
                            for u in fft]
            out["binds"].append({k: row[v] for k, v in bound.items()})
    for name in ("gravity", "avg"):
        out[name] = np.concatenate(out[name])
    return out

"""What every driver (``drivers/<name>.py``) gives the run: the system
under test built from a configuration and a traffic mix, its sinks and
devices, and the program's spectrum state after the window."""

from __future__ import annotations

import numpy as np


class System:
    """A system under test. ``devices``: the torch devices it uses;
    ``sinks``: one :class:`benchlib.live.StampSink` a stream; ``modules``
    and ``pipe`` (name -> (S, 4)): each stream's module and pipe values;
    ``blocks``: each device's streams as (start, stop); ``shapes``: what
    the rooflines count (``n``, ``F``, ``H``, ``W``, and per device
    ``rows``, ``bars_streams``, ``color_rows``)."""

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


def program_rows(parts: list) -> dict:
    """The program's spectrum state as (S, 2 channels, 2 planes, m)
    float32 arrays ``gravity`` and ``avg``, streams in order. ``parts``:
    (FusedChainState, its AudioPipeline, its streams) in stream order;
    its rows are ``s * U + u`` over the pipeline's fft uniforms."""
    out = {"gravity": [], "avg": []}
    for chains, pipeline, S in parts:
        srcs = [u.source for u in pipeline.fft_uniforms]
        order = [srcs.index("audio_l"), srcs.index("audio_r")]
        U = len(srcs)
        for name in out:
            t = getattr(chains, name).detach().float().cpu().numpy()
            out[name].append(t.reshape(S, U, *t.shape[1:])[:, order])
    return {k: np.concatenate(v) for k, v in out.items()}

"""The CPU cores of a run's threads: the serving loop's thread on a core
of its own, the feeder thread on another, and every other thread of the
process (the CUDA driver's, torch's) on the rest. The loop is the host
path most cells measure; so it shares its core with nothing the process
starts."""

from __future__ import annotations

import os


def split() -> dict | None:
    """Move the calling thread, and so every thread it starts from now
    on, onto the rest; returns ``{"loop", "feeder", "rest"}``, or None
    (nothing moved) where fewer than four cores are allowed."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return None
    pins = {"loop": cores[-1], "feeder": cores[-2], "rest": set(cores[:-2])}
    os.sched_setaffinity(0, pins["rest"])
    return pins

"""The benchmark's own library: input making, recording, the device trace,
the metric arithmetic and the correctness check.

Importing this package imports nothing: :mod:`benchlib.pcm`,
:mod:`benchlib.stats` and :mod:`benchlib.roofline` use numpy (and torch)
alone, so the plain reference can share them; the modules that drive the
program import it themselves.
"""

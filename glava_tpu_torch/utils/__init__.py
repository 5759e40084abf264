"""Instrumentation helpers (``profiling``)."""

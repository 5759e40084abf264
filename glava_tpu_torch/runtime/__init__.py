"""Host runtime: capture threads, frame loop, sinks."""

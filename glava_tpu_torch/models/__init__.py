"""Model frontends sharing the port's packed FFT (``mel``)."""

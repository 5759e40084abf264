"""glava_tpu_torch — the PyTorch/CUDA port of glava_tpu.

The same GLava configuration surface and the same spectrum -> frame
pipeline as the JAX package, on torch tensors. The spectrum update
(window, packed FFT, log-magnitude and boost, gravity, ring write and
age-weighted average) runs as one hand-written CUDA kernel when the
tensors live on an NVIDIA GPU (``ops/fused.py``, ``csrc/``); tensors on
the CPU take its plain torch version. This package imports neither
``jax`` nor ``glava_tpu``: it carries its own copies of the numpy-only
configuration modules and reads the shipped shader files from
``glava_tpu/data/shaders`` by path.
"""

__version__ = "0.1.0"

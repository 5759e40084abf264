"""Numerical operators for the audio -> spectrum -> pixels pipeline, on
torch tensors. ``fused`` holds the one CUDA kernel of the main path."""

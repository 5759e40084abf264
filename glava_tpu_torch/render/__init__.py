"""Rasterization: spectrum textures -> RGBA frames, as torch planes."""

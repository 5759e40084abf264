"""The table lookup kernel's bytes (``glava_tpu_torch/csrc/
table_lookup.cu``: ``out[s, p] = table[s, idx[p]]``), each moved once:
the (P,) int32 index plane read, the (S, T) float32 table read and the
(S, P) float32 plane written. The peaks are ``benchlib.roofline``'s."""

from __future__ import annotations

from benchlib import roofline


def lookup_bytes(S: int, T: int, P: int) -> int:
    return P * 4 + S * T * 4 + S * P * 4


def lookup_bound_s(S: int, T: int, P: int) -> float:
    return lookup_bytes(S, T, P) / roofline.HBM_BYTES_PER_S

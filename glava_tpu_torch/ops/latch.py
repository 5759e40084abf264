"""Latch scan: a first-event scan down rows that carries value channels.

The port's counterpart of ``glava_tpu/ops/pallas/latch.py``'s
``build_latch_scan`` (kernel: ``csrc/latch_scan.cu``). The interpreter's
first-hit walk lowering (``config/glsl_shader.py``) runs it with C = 0
for the walk's key scan and with C = 4 to latch the texel a shader
fetches at the walk result.

For an (E, W) float32 key plane and C float32 candidate planes:

* ``reverse=True``: suffix min. Walking rows from the last to the
  first with a running ``(ks, cs)`` that starts at ``(sent, 0)``, row r
  keeps its own (key, candidates) when ``key <= ks``, else it takes the
  running pair.
* ``reverse=False``: prefix max, walking from the first row, a row
  keeping its own pair when ``key >= ks``.

This is the TPU kernel's Hillis-Steele selection rule written as a
recurrence, ties included: on a sentinel-vs-sentinel tie a row keeps
its own candidate, so a row whose scan stays at the sentinel latches
its own candidate (not zeros, as ``build_latch_scan``'s docstring
says). Min and max select exactly, so the kernel and the plain version
agree bit for bit.

* :func:`latch_scan_plain` is the row-sequential torch version.
* :func:`latch_scan` takes it for CPU tensors and launches the kernel
  for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

CHANNELS = (0, 4)

# kernel launches made by latch_scan (CUDA tensors only), by C
launches = dict.fromkeys(CHANNELS, 0)


def latch_scan_plain(key: torch.Tensor, cands, reverse: bool, sent: float):
    """``(key_scan, *latched)`` for an (E, W) key plane and a tuple of
    C (E, W) candidate planes, all float32, row by row."""
    E = key.shape[0]
    ks = torch.full_like(key[0], float(sent))
    cs = [torch.zeros_like(key[0]) for _ in cands]
    okey = torch.empty_like(key)
    outs = [torch.empty_like(key) for _ in cands]
    rows = range(E - 1, -1, -1) if reverse else range(E)
    for r in rows:
        k = key[r]
        own = (k <= ks) if reverse else (k >= ks)
        ks = torch.where(own, k, ks)
        okey[r] = ks
        for c, cand in enumerate(cands):
            cs[c] = torch.where(own, cand[r], cs[c])
            outs[c][r] = cs[c]
    return (okey, *outs)


def latch_scan(key: torch.Tensor, cands, reverse: bool, sent: float):
    """:func:`latch_scan_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors, which raises when the inputs are not what it takes (float32
    (E, W) planes on one card, C in {0, 4}). Any E and W."""
    cands = tuple(cands)
    if key.device.type == "cpu":
        return latch_scan_plain(key, cands, reverse, sent)
    if key.device.type != "cuda":
        raise ValueError(f"latch_scan: unsupported device {key.device}")
    return _launch(key, cands, reverse, sent)


_FN = None


def _kernel():
    """The built kernel's C entry point, resolved once."""
    global _FN
    if _FN is None:
        from glava_tpu_torch.ops import _build

        fn = _build.load("latch_scan").lib.glava_latch_scan
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(key, cands, reverse, sent):
    C = len(cands)
    if C not in CHANNELS:
        raise ValueError(f"latch_scan: C must be one of {CHANNELS}, got {C}")
    if key.ndim != 2 or key.shape[0] < 1 or key.shape[1] < 1:
        raise ValueError(f"latch_scan: key must be a non-empty (E, W) plane, "
                         f"got {tuple(key.shape)}")
    for name, t in (("key", key),) + tuple((f"cands[{i}]", c)
                                           for i, c in enumerate(cands)):
        if t.dtype != torch.float32:
            raise TypeError(f"latch_scan: {name} must be float32, got {t.dtype}")
        if t.device != key.device:
            raise ValueError(f"latch_scan: {name} on {t.device}, key on "
                             f"{key.device}")
        if t.shape != key.shape:
            raise ValueError(f"latch_scan: {name} has shape {tuple(t.shape)}, "
                             f"key {tuple(key.shape)}")
    E, W = key.shape
    key = key.contiguous()
    cands = [c.contiguous() for c in cands]
    okey = torch.empty_like(key)
    outs = [torch.empty_like(key) for _ in cands]

    fn = _kernel()
    cand_ptrs = (ctypes.c_void_p * max(C, 1))(*[c.data_ptr() for c in cands])
    out_ptrs = (ctypes.c_void_p * max(C, 1))(*[o.data_ptr() for o in outs])
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream(key.device).cuda_stream
        err = fn(key.data_ptr(), okey.data_ptr(), cand_ptrs, out_ptrs, C, E,
                 W, int(bool(reverse)), float(sent), stream)
    if err != 0:
        raise RuntimeError(f"latch_scan kernel launch failed: CUDA error {err}")
    launches[C] += 1
    return (okey, *outs)

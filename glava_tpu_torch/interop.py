"""Carrying render state between the JAX package and the port.

The JAX ``RenderState`` comes in with its leaves as numpy arrays (for
example ``jax.tree.map(np.asarray, state)``): a ``chains`` dict holding
either the ``__xla__`` ``RingChainState`` (the default path) or the
``__fused__`` ``FusedChainState``, plus ``key_start``/``key_end``.

* The fused layout is the port's own and carries over as it is.
* An empty ``chains`` dict (a module with no fft uniform, such as
  ``wave``) becomes the port's B = 0 state, and goes back out as an
  empty dict.
* The ring layout interleaves re/im along its last axis, (..., U, sz)
  and (..., U, F, sz); it splits into (B, 2, m) planes with rows
  ``s * U + u``. Its scalar (or per-stream) update count is broadcast
  per row, and the averaged spectrum, which the ring layout does not
  store, is recomputed from the history with the age weights and the
  clamp, so that a frame with ``modified=False`` renders the same.

A batched state (``BatchedRenderer``, a leading stream axis S) comes in
and goes out the same way: the fused layout is flat over the same rows
``s * U + u`` already, the ring layout's (S, U, ...) leaves flatten to
them with each stream's count repeated over its U uniforms, and the
keyframes keep their (S, 2, bufsize) shape.

The baked resample matrices are the only "weights" of the system; both
packages bake them with the same numpy code, bit for bit, so nothing
else needs carrying.
"""

from __future__ import annotations

import numpy as np
import torch

from glava_tpu_torch.config.state import RenderConfig
from glava_tpu_torch.device import resolve
from glava_tpu_torch.ops import fused, windows
from glava_tpu_torch.pipeline import FusedChainState
from glava_tpu_torch.renderer import RenderState


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _planes(inter: np.ndarray) -> np.ndarray:
    """(..., sz) interleaved -> (..., 2, m) planes."""
    return np.stack([inter[..., 0::2], inter[..., 1::2]], axis=-2)


def state_from_jax_numpy(leaves, cfg: RenderConfig, device) -> RenderState:
    """A JAX ``RenderState`` with numpy leaves -> the port's state."""
    dev = resolve(device)
    # copies: the port updates its state buffers in place
    t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    chains = _field(leaves, "chains")
    F = cfg.avg_frames
    if not chains:
        m = cfg.scaled_bufsize // 2
        st = FusedChainState(
            t(np.zeros((0, 2, m), np.float32)),
            t(np.zeros((0, F, 2, m), np.float32)),
            t(np.zeros((0, 2, m), np.float32)),
            t(np.zeros((0,), np.int32)),
        )
    elif "__fused__" in chains:
        c = chains["__fused__"]
        st = FusedChainState(
            t(np.asarray(_field(c, "gravity"), np.float32)),
            t(np.asarray(_field(c, "history"), np.float32)),
            t(np.asarray(_field(c, "avg"), np.float32)),
            t(np.asarray(_field(c, "count"), np.int32) % F),
        )
    elif "__xla__" in chains:
        c = chains["__xla__"]
        grav = np.asarray(_field(c, "gravity"), np.float32)  # (*b, U, sz)
        hist = np.asarray(_field(c, "history"), np.float32)  # (*b, U, F, sz)
        count = np.asarray(_field(c, "count"), np.int32)     # (*b,)
        U, sz = grav.shape[-2:]
        grav = _planes(grav).reshape(-1, 2, sz // 2)
        hist = _planes(hist).reshape(-1, F, 2, sz // 2)
        count = np.repeat(count.reshape(-1) % F, U).astype(np.int32)
        hist_t = t(hist)
        w_age = t(fused.age_weights(
            windows.avg_weights(F, cfg.avg_window, cfg.accel_fft)))
        avg = fused.ring_average(hist_t, t(count) - 1, w_age)
        st = FusedChainState(t(grav), hist_t, avg, t(count))
    else:
        raise ValueError(f"unknown chain state keys {sorted(chains)}")
    return RenderState(
        chains=st,
        key_start=t(np.asarray(_field(leaves, "key_start"), np.float32)),
        key_end=t(np.asarray(_field(leaves, "key_end"), np.float32)),
    )


def state_to_numpy(state: RenderState) -> dict:
    """The port's state -> numpy leaves in the JAX package's
    ``__fused__`` layout (``FusedChainState`` field names); a state of
    no rows gives an empty ``chains`` dict, as the JAX package keeps
    for a module with no fft uniform."""
    c = state.chains
    chains = {} if c.count.numel() == 0 else {"__fused__": {
        k: v.detach().cpu().numpy() for k, v in c._asdict().items()
    }}
    return {
        "chains": chains,
        "key_start": state.key_start.detach().cpu().numpy(),
        "key_end": state.key_end.detach().cpu().numpy(),
    }

"""Device selection: every entry point takes an explicit ``device``."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``"cuda"``/``"cpu"``/``torch.device`` -> a checked torch.device.

    A CUDA device with no card raises: nothing falls back to the CPU.
    On CUDA, TF32 is switched off for matmuls and cuDNN, because the
    reference runs every DSP contraction at full float32
    (``Precision.HIGHEST``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device '{device}' requested but torch.cuda.is_available() "
                "is False"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device '{device}' (cuda or cpu)")
    return dev

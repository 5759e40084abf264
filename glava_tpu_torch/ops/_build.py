"""Build the package's CUDA sources at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, loaded through ``ctypes`` (no PyTorch headers,
so a build takes seconds). Libraries land in ``build/glava_tpu_torch/``
at the root of the checkout, named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads the
library already there.

Nothing here runs at import time: the CPU tests import every module of
the package on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# every kernel of the package, one source each
KERNELS = ("fused_update", "table_lookup", "rowwise_lookup", "latch_scan",
           "bars_raster", "smooth_scan", "graph_while")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "glava_tpu_torch"
# dynamic shared memory one CTA may use on the target (sm_90a: 227 KB);
# the kernels' plans (ops/fused.py, ops/lookup.py) size their layouts to it
SMEM_LIMIT = 232448
# no --use_fast_math: logf accuracy is part of the 2e-5 spectrum contract
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float   # nvcc wall time in this process; 0.0 if reused
    log: str         # nvcc/ptxas output (registers, shared memory)


_LOADED: dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}_{digest}.so"


def load(name: str) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return load_all([name])[name]


def load_all(names=KERNELS) -> dict[str, Built]:
    """Build (if needed) and load several sources (by default every
    kernel of the package), their ``nvcc`` runs started together so the
    builds overlap."""
    jobs = {}
    for name in names:
        if name in _LOADED:
            continue
        src, out = _target(name)
        if out.is_file():
            _LOADED[name] = Built(ctypes.CDLL(str(out)), out, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs[name] = (src, out, tmp, proc, time.perf_counter())
    failed = []
    for name, (src, out, tmp, proc, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src}:\n{log}")
            continue
        os.replace(tmp, out)
        _LOADED[name] = Built(ctypes.CDLL(str(out)), out, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _LOADED[name] for name in names}

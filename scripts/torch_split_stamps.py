"""Where the fused update's split route spends its time, on an NVIDIA GPU.

    python3 scripts/torch_split_stamps.py [BEFORE_DIR]

Builds a copy of this checkout's ``glava_tpu_torch/csrc/fused_update.cu``
with ``clock64()`` and ``%globaltimer`` stamps put in at anchor lines
(the source itself holds none), and, if given, of ``BEFORE_DIR``'s (a
directory holding another tree's ``ops/fused.py`` and
``csrc/fused_update.cu``, for example from ``git show <commit>:<path>``),
and runs each at the split shapes of ``chip_smoke.SPLIT_AB``:

* the span of each launch on the device's global timer: the first CTA's
  start to the last CTA's end of the column pass (A) and of the stage
  pass (B), and B's first start against A's last end (a negative gap is
  the overlap that a programmatic dependent launch buys);
* the phases of CTA 0 of each pass, in cycles from its start. Pass A:
  its tables and audio staged, its first column's FFT, its end. Pass B:
  the prologue (the parameters, and in the redesign the history's
  prefetch issued), the wait for pass A (redesign only), the read of
  the scratch ``Y``, the k-point stage, the wait for the history
  (redesign only) and the epilogue.

The stamped call is the last of one call on each of the shape's input
sets (``chip_smoke._update_sets``, more bytes than the L2 holds), so its
inputs come from device memory, and its output is held against the
plain version (``chip_smoke._tolerance``). A source whose anchors are
missing or not unique fails the run. The builds land in
``build/split_stamps/``. Prints the card's name and power limit beside
the numbers.
"""

from __future__ import annotations

import ctypes
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from glava_tpu_torch.ops import _build, fused  # noqa: E402
from torch_smooth_stamps import build_all, sm_clocks  # noqa: E402

OUT = ROOT / "build" / "split_stamps"

# put before `namespace {`, and at the end of the source
HEADER = """__device__ long long glava_stamps[32];
__device__ unsigned long long glava_span[4];
#define STAMP_AT(i) \\
    if (blockIdx.x == 0 && threadIdx.x == 0) glava_stamps[i] = clock64()
#define GLAVA_NOW(t) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t))
#define SPAN_START(i) \\
    if (threadIdx.x == 0) { \\
        unsigned long long t_; GLAVA_NOW(t_); atomicMin(&glava_span[i], t_); }
#define SPAN_END(i) \\
    __syncthreads(); \\
    if (threadIdx.x == 0) { \\
        unsigned long long t_; GLAVA_NOW(t_); atomicMax(&glava_span[i], t_); }

"""
TRAILER = """
extern "C" int glava_stamps_reset(void)
{
    long long zero[32] = {0};
    unsigned long long span[4] = {~0ull, 0ull, ~0ull, 0ull};
    cudaError_t err = cudaMemcpyToSymbol(glava_stamps, zero, sizeof(zero));
    if (err == cudaSuccess)
        err = cudaMemcpyToSymbol(glava_span, span, sizeof(span));
    return (int)err;
}

extern "C" int glava_stamps_read(long long* stamps, unsigned long long* span)
{
    cudaError_t err = cudaMemcpyFromSymbol(stamps, glava_stamps,
                                           sizeof(glava_stamps));
    if (err == cudaSuccess)
        err = cudaMemcpyFromSymbol(span, glava_span, 4 * sizeof(long long));
    return (int)err;
}
"""

# Stamps: pass A 0 entry, 1 tables and audio staged, 2 first column's
# FFT done, 3 end; pass B 8 entry, 9 prologue done, 10 pass A waited for,
# 11 Y in, 12 stage done, 13 history waited for, 14 end. Spans: 0/1 pass
# A's first start and last end, 2/3 pass B's.
A_NAMES = ((1, "tables and audio staged"), (2, "first column's FFT"),
           (3, "the other columns and the stores of Y"))
B_NAMES = ((9, "prologue"), (10, "wait for pass A"), (11, "read of Y"),
           (12, "k-point stage"), (13, "wait for the history"),
           (14, "epilogue"))

# (anchor, replacement) of the two-launch design whose stage pass reads
# its history from device memory (for example commit 37de1cd's source);
# "{a}" is the anchor
STAMPS_BEFORE = (
    ("    const int ncol = min(cols, k - j0);\n",
     "{a}    SPAN_START(0);\n    STAMP_AT(0);\n"),
    ("        __syncthreads();   // the stage is in; the last column's bins "
     "read\n", "{a}        if (c == 0) STAMP_AT(1);\n"),
    ("        const int j1 = j0 + c;\n", "        if (c == 0) STAMP_AT(2);\n{a}"),
    ("            y[f2] = cmul(in[f2], __ldg(post + f2));\n    }\n}\n",
     "            y[f2] = cmul(in[f2], __ldg(post + f2));\n    }\n"
     "    STAMP_AT(3);\n    SPAN_END(1);\n}\n"),
    ("    const int f20 = (blockIdx.x % blocks) * run;\n",
     "{a}    SPAN_START(2);\n    STAMP_AT(8);\n"),
    ("    const double2* y = a.Y + (size_t)row * m + f20;\n",
     "    STAMP_AT(9);\n{a}"),
    ("    double2* in = buf0;\n    double2* out = buf1;\n    int Ns = 1;\n"
     "    for (int s = 0; s < a.kstages; ++s) {\n", "    STAMP_AT(11);\n{a}"),
    ("    // the epilogue of bins f1*m2 + f20 + col, held at in[f1*run + col]\n",
     "    STAMP_AT(12);\n{a}"),
    ("        avg[at] = fminf(fmaxf(acc, 0.0f), 1.0f);\n    }\n}\n",
     "        avg[at] = fminf(fmaxf(acc, 0.0f), 1.0f);\n    }\n"
     "    STAMP_AT(14);\n    SPAN_END(3);\n}\n"),
)

# the redesign (the stage pass prefetches its history, then waits for
# pass A: griddepcontrol)
STAMPS_PDL = (
    ("    const int j0 = (blockIdx.x % blocks) * kCols;\n",
     "{a}    SPAN_START(0);\n    STAMP_AT(0);\n"),
    ("        __syncthreads();   // the stage is in; the last column's bins "
     "read\n", "{a}        if (c == 0) STAMP_AT(1);\n"),
    ("        const int j1 = j0 + c;\n", "        if (c == 0) STAMP_AT(2);\n{a}"),
    ("    }   // the columns\n}\n",
     "    }\n    STAMP_AT(3);\n    SPAN_END(1);\n}\n"),
    ("    const int f20 = (blockIdx.x % blocks) * run;\n",
     "{a}    SPAN_START(2);\n    STAMP_AT(8);\n"),
    ("    grid_dependency_wait();   // pass A's Y is complete and visible\n",
     "    STAMP_AT(9);\n{a}    STAMP_AT(10);\n"),
    ("    __syncthreads();   // Y is in\n", "{a}    STAMP_AT(11);\n"),
    ("    float* __restrict__ grav = a.grav + (size_t)row * plane;\n",
     "    STAMP_AT(12);\n{a}"),
    ("    wait_history<kTensor>(bars, 0);\n", "{a}    STAMP_AT(13);\n"),
    ("    }   // the averages\n}\n",
     "    }\n    STAMP_AT(14);\n    SPAN_END(3);\n}\n"),
)


def stamped(src: str) -> str:
    """``src`` with the stamps of its design."""
    patches = STAMPS_PDL if "griddepcontrol.wait" in src else STAMPS_BEFORE
    for anchor, repl in patches:
        if src.count(anchor) != 1:
            raise ValueError(f"stamp anchor found {src.count(anchor)} times, "
                             f"not once: {anchor!r}")
        src = src.replace(anchor, repl.replace("{a}", anchor))
    if src.count("namespace {\n") != 1:
        raise ValueError("no single `namespace {` to put the stamps before")
    return src.replace("namespace {\n", HEADER + "namespace {\n") + TRAILER


def run_stamped(lib: ctypes.CDLL, mod, n: int, B: int, what: str):
    """One call of ``mod.fused_update`` served by ``lib`` on each input
    set, the stamped one last; its stamps and spans after holding its
    output against the plain version."""
    reset, read = lib.glava_stamps_reset, lib.glava_stamps_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    reset.restype = read.restype = ctypes.c_int
    sets = cs._update_sets(n, B)
    args = sets[0]
    pg, _, pavg = fused.fused_update_plain(*args)
    tol = cs._tolerance(args, pg, pavg)
    built = _build.Built(lib, Path(lib._name), 0.0, "")
    with cs._serving(built):
        mod._FN.clear()
        for s in sets[1:] + sets[1:]:
            mod.fused_update(*s)
        torch.cuda.synchronize()
        if reset() != 0:
            raise RuntimeError(f"{what}: resetting the stamps failed")
        before = mod.split_launches
        kg, _, kavg = mod.fused_update(*args)
        torch.cuda.synchronize()
        mod._FN.clear()
    err = max((kg - pg).abs().max().item(), (kavg - pavg).abs().max().item())
    if mod.split_launches != before + 1 or not err <= tol:
        raise AssertionError(f"{what}: err {err} against the plain version "
                             f"(tolerance {tol})")
    stamps = (ctypes.c_longlong * 32)()
    span = (ctypes.c_ulonglong * 4)()
    if read(stamps, span) != 0:
        raise RuntimeError(f"{what}: reading the stamps failed")
    return list(stamps), list(span), err


def line(st: list[int], span: list[int]) -> str:
    a = ", ".join(f"{name} {st[i] - st[i - 1]}" for i, name in A_NAMES)
    b_at = [(i, name) for i, name in B_NAMES if st[i]]
    b, prev = [], 8
    for i, name in b_at:
        b.append(f"{name} {st[i] - st[prev]}")
        prev = i
    return (f"spans (ns, global timer): A {span[1] - span[0]}, B "
            f"{span[3] - span[2]}, B's first start - A's last end "
            f"{span[2] - span[1]:+d}, whole {span[3] - span[0]}; CTA 0 "
            f"cycles: A whole {st[3] - st[0]} ({a}); B whole {st[14] - st[8]} "
            f"({', '.join(b)})")


def main(argv: list[str]) -> int:
    if len(argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    card = cs.phase_device()
    OUT.mkdir(parents=True, exist_ok=True)
    trees = {"this": (_build.CSRC / "fused_update.cu", fused)}
    if argv:
        before = Path(argv[0])
        spec = importlib.util.spec_from_file_location("fused_before",
                                                      before / "fused.py")
        old = importlib.util.module_from_spec(spec)
        sys.modules["fused_before"] = old       # dataclasses look it up
        spec.loader.exec_module(old)
        trees[before.name] = (before / "fused_update.cu", old)
    jobs = {}
    for name, (cu, _) in trees.items():
        out = OUT / f"{name}.cu"
        out.write_text(stamped(cu.read_text()))
        jobs[name] = out
    libs = build_all(jobs, OUT)
    for n, B in cs.SPLIT_AB:
        for rnd in range(2):
            for name, (_, mod) in trees.items():
                st, span, err = run_stamped(libs[name], mod, n, B,
                                            f"{name} n{n} B{B}")
                print(f"[stamps] {name} n{n} B{B} round {rnd}: "
                      f"{line(st, span)}; err {err:.2e} ({card})")
    print(f"[stamps] SM clock now, max: {sm_clocks()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

"""Where the smooth scan's cycles go, on an NVIDIA GPU (sm_90a).

    python3 scripts/torch_smooth_stamps.py [BEFORE_DIR]

1. The latency of each chain of ``scripts/torch_smooth_probe.cu`` (one
   thread, ``clock64()``): the floors of the walks' steps.
2. This checkout's ``glava_tpu_torch/csrc/smooth_scan.cu``, copied with
   ``clock64()`` stamps put in at anchor lines (the source itself holds
   none) and built twice: level 1 stamps block 0's phases, level 2 also
   each step of the fast walk's loop (the stamps' own cycles inside
   them). Run at 1 row, sz 4096, ratio 4 and 1, d 0.01 on a live row
   (``chip_smoke.smooth_live_rows``), on the fast walk and again with
   every bin from 1 on the exact walk.
3. ``BEFORE_DIR``, if given, holds another tree's ``ops/smooth.py`` and
   ``csrc/smooth_scan.cu`` of the one-walk design (the prefix-statistics
   walk alone; for example from ``git show <commit>:<path>``), stamped
   the same way: its prefix pass, its walk, and each step of the walk.

A source whose anchors are missing or not unique fails the run. The
builds land in ``build/smooth_stamps/``. Every output is held against
the plain version (``chip_smoke.SMOOTH_TOL``). Prints the card's name,
power limit and SM clock beside the cycles.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from glava_tpu_torch.ops import _build, smooth  # noqa: E402

OUT = ROOT / "build" / "smooth_stamps"
PROBE = ROOT / "scripts" / "torch_smooth_probe.cu"

# the probe's chains, in its order
PROBE_STEPS = ("float64 add", "float64 multiply", "float64 fma",
               "float64 multiply + float64->float32->float64",
               "fast walk recurrence over 3 bins: to float64, 3 float64 "
               "adds, multiply, to float32, 2 float32 fmas",
               "float32 fma (the fast walk's chain)", "float32 IEEE division",
               "exact walk float chain: s -= float64(float32(s + e) / c)",
               "shared store + load + float64 add", "L1-hit global load")

# put before `namespace {`, and at the end of the source
HEADER = """__device__ long long glava_stamps[32];
#define STAMP_AT(i) \\
    if (blockIdx.x == 0 && threadIdx.x == 0) glava_stamps[i] = clock64()
#define STAMP_PUT(i, v) \\
    if (blockIdx.x == 0 && threadIdx.x == 0) glava_stamps[i] = (v)
#define STAMP_CLEAR() \\
    if (blockIdx.x == 0 && threadIdx.x == 0) \\
        for (int i = 0; i < 32; ++i) glava_stamps[i] = 0

"""
TRAILER = """
extern "C" int glava_stamps_read(long long* host)
{
    return (int)cudaMemcpyFromSymbol(host, glava_stamps, sizeof(glava_stamps));
}
"""


def _clocks(names: str) -> str:
    return "".join(f"        const long long {c} = clock64();\n"
                   for c in names.split())


def _segs(n: int) -> str:
    return "".join(f"        seg[{i}] += c{i + 1} - c{i};\n" for i in range(n))


# (anchor, replacement, level) for the two-walk design; "{a}" is the
# anchor. Stamps: 0 entry, 11/12 inside the input's prefix pass, 1 after
# it, 2 after the bin tables, 7 after the fast walk, 3 after the zero
# scan, 10 the exact walk's first bin, 4/5 around the exact walk, 6 end;
# 16-19 the fast walk's step segments
STAMPS_FAST = (
    ("    __shared__ int first_inf, fast_end, zero_at;\n",
     "{a}    STAMP_CLEAR();\n    STAMP_AT(0);\n", 1),
    ("    for (int d = 16; d > 0; d >>= 1) {\n",
     "    if (kInput) STAMP_AT(11);\n{a}", 1),
    ("    Sum3 carry = {0.0, 0, 0};\n", "    if (kInput) STAMP_AT(12);\n{a}", 1),
    ("    // each bin's count, original sum, NaN class and T flags;",
     "    STAMP_AT(1);\n{a}", 1),
    ("    const int end = min(fast_end, max(exact_from, 1));\n",
     "    STAMP_AT(2);\n{a}", 1),
    ("    segment_prefix<false>(", "    STAMP_AT(7);\n{a}", 1),
    ("    const int h = min(end, zero_at + 1);\n",
     "    STAMP_AT(3);\n{a}    STAMP_PUT(10, h);\n", 1),
    ("        if (threadIdx.x == 0) exact_walk(P, SS, bounds, ys, h, asz);\n",
     "        STAMP_AT(4);\n{a}        STAMP_AT(5);\n", 1),
    ("        dst[t] = isnan(v) ? 0.0f : v;\n    }\n}\n",
     "        dst[t] = isnan(v) ? 0.0f : v;\n    }\n    STAMP_AT(6);\n}\n", 1),
    ("    const int last = asz - 1;\n    auto at = [last](int i) { return "
     "min(i, last); };\n", "    long long seg[4] = {0, 0, 0, 0};\n{a}", 2),
    ("        const float v = fmaf(v1, A1, inner);        // the chain\n",
     _clocks("c0") + "{a}" + _clocks("c1"), 2),
    ("        const int lo3l = (int)(rb[at(t + 5)].lf & kLoMask);\n",
     "{a}" + _clocks("c2"), 2),
    ("        const float innern = fmaf(v1, pn ? 0.0f : f1.a2, pn ? 0.0f : "
     "gf1);\n", "{a}" + _clocks("c3"), 2),
    ("            prefetch_l1(vd + min(lo3 + kAhead, t));\n        }\n",
     "{a}" + _clocks("c4") + _segs(4), 2),
    ("        lo3n = lo3l;\n    }\n",
     "{a}    for (int i = 0; i < 4; ++i) STAMP_PUT(16 + i, seg[i]);\n", 2),
)

# the one-walk design: 0 entry, 1 after the prefix pass, 2 the walk's
# first step, 3 end; 20-24 the walk's step segments
STAMPS_PREFIX_WALK = (
    ("    const Table S(base, n, sz + 1);     // S[k]: the smoothed bins "
     "[0, k)\n", "{a}    STAMP_CLEAR();\n    STAMP_AT(0);\n", 1),
    ("    if (threadIdx.x != 0 || asz < 1) return;\n", "    STAMP_AT(1);\n{a}", 1),
    ("    for (int t = 1; t < asz; ++t) {\n", "    STAMP_AT(2);\n{a}", 1),
    ("        slo = slon;\n    }\n}\n",
     "        slo = slon;\n    }\n    STAMP_AT(3);\n}\n", 1),
    ("    STAMP_AT(2);\n", "    long long seg[5] = {0, 0, 0, 0, 0};\n{a}", 2),
    ("    for (int t = 1; t < asz; ++t) {\n", "{a}" + _clocks("c0"), 2),
    ("        Stat slon = wn.x == t ? cur : (wn.x > t ? zero_stat() : "
     "S.get(wn.x));\n", "{a}" + _clocks("c1"), 2),
    ("        const float v = mean((cur - slo) + (phi - pt));\n",
     "        const Stat win = (cur - slo) + (phi - pt);\n" + _clocks("c2")
     + "        const float v = mean(win);\n" + _clocks("c3"), 2),
    ("        S.put(t + 1, cur);\n",
     _clocks("c4") + "{a}" + _clocks("c5") + _segs(5), 2),
    ("    STAMP_AT(3);\n",
     "{a}    for (int i = 0; i < 5; ++i) STAMP_PUT(20 + i, seg[i]);\n", 2),
)


def stamped(src: str, level: int) -> str:
    """``src`` with the stamps of its design up to ``level``."""
    patches = STAMPS_FAST if "fast_walk" in src else STAMPS_PREFIX_WALK
    for anchor, repl, lvl in patches:
        if lvl > level:
            continue
        if src.count(anchor) != 1:
            raise ValueError(f"stamp anchor found {src.count(anchor)} times, "
                             f"not once: {anchor!r}")
        src = src.replace(anchor, repl.replace("{a}", anchor))
    if src.count("namespace {\n") != 1:
        raise ValueError("no single `namespace {` to put the stamps before")
    return src.replace("namespace {\n", HEADER + "namespace {\n") + TRAILER


def build_all(jobs: dict[str, Path], out: Path = OUT) -> dict[str, ctypes.CDLL]:
    """nvcc each source of ``jobs`` (name -> .cu) side by side into
    ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, cu in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(f"[stamps] {name} built: " + " | ".join(
            ln.strip() for ln in log.splitlines() if "registers" in ln))
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def chain_latencies(lib: ctypes.CDLL, n: int = 4096) -> list[float]:
    """Cycles a step of each probe chain (n steps; the second of two
    runs)."""
    fn = lib.glava_chain_latency
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = torch.tensor([1.0000001, 0.25, 0.5, 1.0001, 3.0, 0.3, 0.0],
                        dtype=torch.float64, device="cuda")
    nxt = torch.arange(64, dtype=torch.int32, device="cuda")
    sink = torch.empty(1, dtype=torch.float64, device="cuda")
    cycles = torch.empty(len(PROBE_STEPS), dtype=torch.int64, device="cuda")
    for _ in range(2):
        err = fn(args.data_ptr(), nxt.data_ptr(), sink.data_ptr(),
                 cycles.data_ptr(), n, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"probe launch failed: CUDA error {err}")
        torch.cuda.synchronize()
    return [c / n for c in cycles.tolist()]


def sm_clocks() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def run_stamped(lib: ctypes.CDLL, call, x: torch.Tensor, want: torch.Tensor,
                asz: int, what: str) -> list[int]:
    """Three calls of ``call(x)`` served by ``lib``; the stamps of the
    last, after holding its output against ``want``."""
    read = lib.glava_stamps_read
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    built = _build.Built(lib, Path(lib._name), 0.0, "")
    with cs._serving(built, "smooth_scan"):
        for _ in range(3):
            got = call(x)
            torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= cs.SMOOTH_TOL or not torch.equal(got == 0, want == 0):
        raise AssertionError(f"{what}: err {err} against the plain version")
    cs._check_live(got, asz, what)
    host = (ctypes.c_longlong * 32)()
    if read(host) != 0:
        raise RuntimeError(f"{what}: reading the stamps failed")
    return list(host)


def fast_line(st: list[int], level: int, asz: int) -> str:
    h = st[10]
    fast_bins, exact_bins = min(h, asz) - 1, asz - min(h, asz)
    line = (f"exact walk from bin {h}: prepass {st[1] - st[0]} (pass 1 "
            f"{st[11] - st[0]}, sums {st[12] - st[11]}, pass 2 "
            f"{st[1] - st[12]}), bin tables {st[2] - st[1]}, fast walk "
            f"{st[7] - st[2]}")
    if fast_bins > 0:
        line += f" ({(st[7] - st[2]) / fast_bins:.1f} a bin)"
    line += f", its prefix and zero scan {st[3] - st[7]}"
    if exact_bins > 0:
        line += (f", rebuild {st[4] - st[3]}, exact walk {st[5] - st[4]} "
                 f"({(st[5] - st[4]) / exact_bins:.1f} a bin)")
    line += f", whole {st[6] - st[0]} cycles"
    if level == 2 and fast_bins > 0:
        line += ("; fast walk a bin: chain fma "
                 f"{st[16] / fast_bins:.1f}, stores and loads "
                 f"{st[17] / fast_bins:.1f}, next bin's NaN class and fmas "
                 f"{st[18] / fast_bins:.1f}, T and G two bins ahead "
                 f"{st[19] / fast_bins:.1f}")
    return line


def prefix_walk_line(st: list[int], level: int, asz: int) -> str:
    bins = asz - 1
    line = (f"prefix pass {st[1] - st[0]}, walk set-up {st[2] - st[1]}, walk "
            f"{st[3] - st[2]} ({(st[3] - st[2]) / bins:.1f} a bin), whole "
            f"{st[3] - st[0]} cycles")
    if level == 2:
        line += ("; a bin: loads " f"{st[20] / bins:.1f}, window difference "
                 f"{st[21] / bins:.1f}, mean {st[22] / bins:.1f}, store + "
                 f"stat_of + add {st[23] / bins:.1f}, S.put {st[24] / bins:.1f}")
    return line


def main(argv: list[str]) -> int:
    if len(argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    card = cs.phase_device()
    before = Path(argv[0]) if argv else None
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {"probe": PROBE}
    for level in (1, 2):
        cu = OUT / f"this_{level}.cu"
        cu.write_text(stamped((_build.CSRC / "smooth_scan.cu").read_text(),
                              level))
        jobs[f"this_{level}"] = cu
        if before is not None:
            cu = OUT / f"before_{level}.cu"
            cu.write_text(stamped((before / "smooth_scan.cu").read_text(),
                                  level))
            jobs[f"before_{level}"] = cu
    libs = build_all(jobs)
    old = None
    if before is not None:
        spec = importlib.util.spec_from_file_location("smooth_before",
                                                      before / "smooth.py")
        old = importlib.util.module_from_spec(spec)
        sys.modules["smooth_before"] = old
        spec.loader.exec_module(old)

    steps = chain_latencies(libs["probe"])
    for name, c in zip(PROBE_STEPS, steps):
        print(f"[stamps] probe {name}: {c:.2f} cycles a step ({card})")
    print(f"[stamps] SM clock now, max: {sm_clocks()}")
    for sz, ratio, d in ((4096, 4.0, 0.01), (4096, 1.0, 0.01)):
        asz = -(-sz // int(ratio))
        x = torch.as_tensor(cs.smooth_live_rows(sz, 1)[0], device="cuda")
        want = smooth.smooth_transform_plain(x, ratio, d)
        shape = f"1 live row sz {sz} r {ratio:g} d {d:g}"
        print(f"[stamps] {shape}: chain floor {asz} x {steps[5]:.2f} = "
              f"{asz * steps[5]:.0f} cycles (a float32 fma a bin), recurrence "
              f"floor {asz} x {steps[4]:.2f} / 3 = {asz * steps[4] / 3:.0f} "
              "cycles (as probed)")
        for level in (1, 2):
            lib = libs[f"this_{level}"]
            for walk, call in (
                    ("fast", lambda v: smooth.smooth_transform(v, ratio, d)),
                    ("exact from bin 1",
                     lambda v: smooth._launch(v, ratio, d, 1))):
                smooth._FN = None
                st = run_stamped(lib, call, x, want, asz,
                                 f"this level {level} {walk}")
                smooth._FN = None
                print(f"[stamps] this kernel, level {level}, {shape}, {walk}:"
                      f" {fast_line(st, level, asz)} ({card})")
            if old is not None:
                lib = libs[f"before_{level}"]
                old._FN = None
                st = run_stamped(
                    lib, lambda v: old.smooth_transform(v, ratio, d), x, want,
                    asz, f"before level {level}")
                old._FN = None
                print(f"[stamps] {before} kernel, level {level}, {shape}: "
                      f"{prefix_walk_line(st, level, asz)} ({card})")
    print(f"[stamps] SM clock now, max: {sm_clocks()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

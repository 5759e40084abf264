// Latch scan for NVIDIA Hopper (sm_90a): a first-event scan down the
// rows of a key plane that carries C value channels from the winning row.
//
// Replaces the TPU kernel glava_tpu/ops/pallas/latch.py:build_latch_scan
// (its pl.pallas_call in _build). For an (E, W) float32 key plane and C
// float32 candidate planes of the same shape:
//
//   reverse = 1: suffix min. Walking rows E-1 .. 0 with a running
//                (ks, cs) that starts at (sent, 0):
//                row r keeps its own (key, cands) when key <= ks,
//                else it takes the running pair.
//   reverse = 0: prefix max. Walking rows 0 .. E-1 the same way, a row
//                keeping its own pair when key >= ks.
//
// That is the Pallas kernel's Hillis-Steele selection rule read as a
// sequential recurrence (the combine is associative, ties go to the
// row itself), so a row whose scan stays at the sentinel latches its
// OWN candidate, not zeros. The selection is exact, so the result is
// bit-identical to the plain torch version (ops/latch.py).
//
// Design: one thread per column walks the E rows in the scan direction
// with the running key and the C values in registers; neighbouring
// threads read and write neighbouring columns, so every load and store
// is coalesced. C is a template parameter (0 or 4). None of the TPU
// kernel's Hillis-Steele shifting, VMEM aliasing or padding to (8, 128)
// is needed here: any E and W.
//
// What bounds it: data movement. Each of the 1 + C input planes is read
// once and each output plane written once: at (1081, 1920) that is
// 16.6 MB for C = 0 (~5.0 us at 3.35 TB/s) and 83 MB for C = 4
// (~24.8 us). With one thread per column, W = 1920 gives only 30 blocks
// of 64 threads, so the kernel runs far below the card's memory
// parallelism and is expected to be latency-bound; a chunked two-level
// scan over row blocks is the way to more parallelism.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxC = 4;

struct Planes {
    const float* cand[kMaxC];
    float* out[kMaxC];
};

template <int C, bool kReverse>
__global__ void __launch_bounds__(kThreads)
latch_scan_kernel(const float* __restrict__ key, float* __restrict__ okey,
                  Planes planes, int E, int W, float sent)
{
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= W) return;
    float ks = sent;
    float cs[C > 0 ? C : 1];
#pragma unroll
    for (int c = 0; c < C; ++c) cs[c] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < E; ++t) {
        const int r = kReverse ? E - 1 - t : t;
        const size_t at = (size_t)r * W + col;
        const float k = __ldg(key + at);
        const bool own = kReverse ? (k <= ks) : (k >= ks);
        if (own) ks = k;
        okey[at] = ks;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float v = __ldg(planes.cand[c] + at);
            if (own) cs[c] = v;
            planes.out[c][at] = cs[c];
        }
    }
}

template <int C>
cudaError_t launch(const float* key, float* okey, const Planes& p, int E,
                   int W, int reverse, float sent, cudaStream_t stream)
{
    const dim3 grid((W + kThreads - 1) / kThreads);
    if (reverse)
        latch_scan_kernel<C, true><<<grid, kThreads, 0, stream>>>(
            key, okey, p, E, W, sent);
    else
        latch_scan_kernel<C, false><<<grid, kThreads, 0, stream>>>(
            key, okey, p, E, W, sent);
    return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The
// caller validates: E, W >= 1, C in {0, 4}, every pointer a contiguous
// (E, W) float32 device buffer; `cands` and `outs` hold C pointers.
extern "C" int glava_latch_scan(const void* key, void* okey,
                                const void* const* cands,
                                void* const* outs, int C, int E, int W,
                                int reverse, float sent, void* stream)
{
    if (E < 1 || W < 1) return (int)cudaErrorInvalidValue;
    Planes p = {};
    for (int c = 0; c < C && c < kMaxC; ++c) {
        p.cand[c] = (const float*)cands[c];
        p.out[c] = (float*)outs[c];
    }
    const cudaStream_t s = (cudaStream_t)stream;
    switch (C) {
    case 0:
        return (int)launch<0>((const float*)key, (float*)okey, p, E, W,
                              reverse, sent, s);
    case 4:
        return (int)launch<4>((const float*)key, (float*)okey, p, E, W,
                              reverse, sent, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

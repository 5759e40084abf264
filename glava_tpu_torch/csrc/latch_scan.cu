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
// sequential recurrence, ties going to the row itself, so a row whose
// scan stays at the sentinel latches its OWN candidate, not zeros. The
// result is bit-identical to the plain torch version (ops/latch.py).
//
// What bounds it on this card: bytes. Each of the 1 + C input planes is
// read once and each output plane written once: at (1081, 1920) 16.6 MB
// for C = 0 (5.0 us at 3.35 TB/s) and 83 MB for C = 4 (24.8 us); the
// compares are a few per element. Reaching the memory rate takes
// megabytes in flight, so the work is cut into many independent loads.
//
// Design: a chunked single-pass scan, one launch. A CTA owns a tile of
// kTile adjacent columns (one 32-byte sector of each row) and all E
// rows of it; its kChunks x kTile threads split the rows into kChunks
// chunks of L consecutive rows (in scan order), one column each:
//
//   A. each thread loads its chunk's keys into registers, every load
//      issued before any is used, and reduces them to the chunk's
//      aggregate: its best key and the row that holds it, ties going to
//      the later row in scan order (the recurrence above, run from the
//      chunk's first row);
//   B. the aggregates go to shared memory; after one barrier each
//      thread folds the aggregates of the chunks before its own, in
//      scan order, into the running pair from (sent, row -1): its
//      chunk's carry-in;
//   C. each thread walks its chunk again from the carry-in with the
//      keys still in registers and writes the key scan; for C = 4 it
//      writes, for each channel, the winning row's value: the row's own
//      (read coalesced, and only where the row wins) or the carry row's
//      (one load; row -1 is 0.0).
//
// Why the combine is exact: the recurrence keeps, at each row, the key
// of the LAST row (in scan order) whose key is best so far, provided it
// is at least as good as the start (a total preorder under <= or >=,
// so "best, latest on ties" is well defined); phase A's aggregate is
// that row within a chunk, phase B's fold applies the same rule to the
// chunk aggregates in the same order, and phase C re-runs the
// recurrence itself from the carry. No value is computed, only
// selected. NaN keys never win (every compare with NaN is false), as in
// the plain version: an aggregate starts as NaN ("no row yet"), takes
// the chunk's first non-NaN key, and a NaN aggregate never wins a fold.
//
// Sizes: kTile 8, kChunks 64 (512 threads, 2 CTAs an SM), L = ceil(E /
// 64) up to kRows 20 keys a thread: (1081, 1920) gives 240 CTAs of 17
// rows a thread, (601, 800) 100 CTAs of 10 rows. Taller planes (E above
// 64 * 20 = 1280 rows) run as row super-blocks of 1280 rows in scan
// order inside the same CTA, the running pair carried between them
// through shared memory. Any E, W >= 1. C is a template parameter (0 or
// 4).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;                    // columns a CTA: 32 bytes a row
constexpr int kChunks = 64;                 // row chunks a CTA
constexpr int kThreads = kTile * kChunks;   // 512
constexpr int kRows = 20;                   // most keys a thread holds
constexpr int kMaxC = 4;

struct Planes {
    const float* cand[kMaxC];
    float* out[kMaxC];
};

// `k` takes over from `ref` in the scan direction (ties go to k)
template <bool kReverse>
__device__ __forceinline__ bool wins(float k, float ref)
{
    return kReverse ? (k <= ref) : (k >= ref);
}

template <int C, bool kReverse>
__global__ void __launch_bounds__(kThreads, 2)
latch_scan_kernel(const float* __restrict__ key, float* __restrict__ okey,
                  Planes planes, int E, int W, int L, float sent)
{
    __shared__ float agg_k[kChunks][kTile];
    __shared__ int agg_r[kChunks][kTile];
    __shared__ float carry_k[kTile];
    __shared__ int carry_r[kTile];

    const int tc = threadIdx.x % kTile;
    const int q = threadIdx.x / kTile;
    const int col = blockIdx.x * kTile + tc;
    const bool live = col < W;
    const int span = kChunks * L;   // rows of one super-block
    if (threadIdx.x < kTile) {
        carry_k[threadIdx.x] = sent;
        carry_r[threadIdx.x] = -1;
    }

    for (int base = 0; base < E; base += span) {
        // this thread's rows: scan positions t0 .. t0 + n - 1
        const int t0 = base + q * L;
        const int n = live ? max(0, min(L, E - t0)) : 0;
        const int step = kReverse ? -W : W;
        const size_t first = (size_t)(kReverse ? E - 1 - t0 : t0) * W + col;
        const int r0 = kReverse ? E - 1 - t0 : t0;
        const int dr = kReverse ? -1 : 1;

        // A: keys into registers, then the chunk aggregate
        float k[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
            if (i < n) k[i] = __ldg(key + first + (ptrdiff_t)i * step);
        float ak = __int_as_float(0x7fc00000);   // NaN: no row yet
        int ar = -1;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
            if (i < n && (wins<kReverse>(k[i], ak) || ak != ak)) {
                ak = k[i];
                ar = r0 + i * dr;
            }
        agg_k[q][tc] = ak;
        agg_r[q][tc] = ar;
        __syncthreads();

        // B: the carry-in, folding earlier chunks in scan order
        float ck = carry_k[tc];
        int cr = carry_r[tc];
        for (int p = 0; p < q; ++p) {
            const float bk = agg_k[p][tc];
            if (wins<kReverse>(bk, ck)) {
                ck = bk;
                cr = agg_r[p][tc];
            }
        }
        __syncthreads();   // every carry_k read before the last chunk writes it
        if (q == kChunks - 1) {   // the carry into the next super-block
            carry_k[tc] = wins<kReverse>(ak, ck) ? ak : ck;
            carry_r[tc] = wins<kReverse>(ak, ck) ? ar : cr;
        }

        // C: the rescan from the carry-in
        float ks = ck;
        uint32_t own = 0;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
            if (i < n) {
                if (wins<kReverse>(k[i], ks)) {
                    ks = k[i];
                    own |= 1u << i;
                }
                okey[first + (ptrdiff_t)i * step] = ks;
            }
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float* cand = planes.cand[c];
            float v[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
                if (i < n && (own >> i & 1u))
                    v[i] = __ldg(cand + first + (ptrdiff_t)i * step);
            float cs = (n > 0 && cr >= 0) ? __ldg(cand + (size_t)cr * W + col)
                                          : 0.0f;
#pragma unroll
            for (int i = 0; i < kRows; ++i)
                if (i < n) {
                    if (own >> i & 1u) cs = v[i];
                    planes.out[c][first + (ptrdiff_t)i * step] = cs;
                }
        }
        __syncthreads();   // aggregates and carry read before the next block
    }
}

template <int C>
cudaError_t launch(const float* key, float* okey, const Planes& p, int E,
                   int W, int reverse, float sent, cudaStream_t stream)
{
    const int L = min((E + kChunks - 1) / kChunks, kRows);
    const dim3 grid((W + kTile - 1) / kTile);
    if (reverse)
        latch_scan_kernel<C, true><<<grid, kThreads, 0, stream>>>(
            key, okey, p, E, W, L, sent);
    else
        latch_scan_kernel<C, false><<<grid, kThreads, 0, stream>>>(
            key, okey, p, E, W, L, sent);
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

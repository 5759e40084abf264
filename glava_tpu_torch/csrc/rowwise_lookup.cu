// Row-wise lookup for NVIDIA Hopper (sm_90a):
//   out[c][i, j] = tabs[c][i, idx[i, j]]   for c < C, C in {1, 4}.
//
// Replaces two TPU kernels of glava_tpu/ops/pallas/lookup.py:
// build_rowwise_lookup (the pl.pallas_call in _build_rowwise) and
// build_rowwise_lookup_mc (the pl.pallas_call in _build_rowwise_mc).
// Each row i gathers from its OWN table row. The interpreter's
// column-aligned texel fetch `texelFetch(prev, ivec2(col + d, y), 0)`
// at a runtime y is this with i = column, j = row, the tables being the
// columns of the previous pass's (H, W) channel planes. The TPU version
// transposes the planes and pads them to 128 lanes so that a per-row
// gather becomes a lane shuffle; none of that is carried over.
//
// Layouts: every operand is read and written through its own row and
// element strides (in floats / ints), so the caller hands over
// `plane.T` views of (H, W) planes with no transposed copy. Indices
// must lie in [0, T); one outside reads as NaN (the kernel never reads
// outside a table).
//
// What bounds it: data movement. At 1920x1080 with C = 4 the function
// reads the 8.3 MB index plane and four 8.3 MB tables and writes four
// 8.3 MB outputs, ~75 MB, ~22 us at 3.35 TB/s; C = 1 moves ~25 MB,
// ~7.4 us. Gathering straight from device memory costs a 32-byte
// sector for every 4-byte value (the indices are data), so the design
// moves whole tables instead:
//
// * A grid without 64-bit division: CTA x owns a strip of S adjacent
//   table rows i (S = 16 or 8, adjacent columns of the (H, W) plane, so
//   one plane row of the strip is one 64- or 32-byte segment). Its 512
//   threads are S lanes of i by 512 / S lanes of j, the faster of the
//   two along the index plane's contiguous dimension, so index reads
//   and output writes coalesce.
// * Staged route (ops/lookup.py rowwise_plan: the widest strip whose
//   index plane and min(C, 2) tables fit in shared memory): the CTA
//   covers every point of its strip. It copies the strip's index plane
//   and first tables in with cp.async, 16 bytes a copy where the layout
//   allows it, then gathers channel c from shared memory and stores it
//   while channel c + 1's table copies into the other buffer. Index
//   and tables cross device memory once.
// * Direct route (larger T or P): CTA (x, y) covers a band of points,
//   the table values read from the L2, the index read once for all C
//   and prefetched a group ahead, all C x kUnroll loads of a group
//   issued before its stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;                     // points a thread has in flight
constexpr int kMaxC = 4;
constexpr int kMaxDevices = 64;                 // per-device opt-ins

struct Args {
    const float* tab[kMaxC];
    float* out[kMaxC];
    long long tab_si, tab_st;      // table strides: row, element
    long long idx_si, idx_sj;      // index strides: row, point
    long long out_si, out_sj;      // output strides: row, point
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `kPending` of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// Copies an (ns x L) strip of a 2-D array (strides si, sl) into shared
// memory at r * dr + l * dl with cp.async, neighbouring threads on the
// source's contiguous dimension: 16 bytes a copy where four neighbours
// on that dimension lie in one aligned 16-byte word at both ends, else
// 4 bytes a copy.
template <int S>
__device__ __forceinline__ void stage_strip(float* dst, const float* src,
                                            long long si, long long sl,
                                            int ns, int L, int dr, int dl)
{
    const int tid = threadIdx.x;
    const bool aligned = ((uintptr_t)src & 15) == 0;
    if (si <= sl) {                                // r contiguous: r fastest
        if (aligned && si == 1 && (sl & 3) == 0 && dr == 1 && (dl & 3) == 0
            && ns == S) {
            constexpr int kQ = S / 4;              // 16-byte words a row
            for (int e = tid; e < kQ * L; e += kThreads) {
                const int r = (e % kQ) * 4, l = e / kQ;
                cp_async16(dst + r + l * dl, src + r + (long long)l * sl);
            }
            return;
        }
        for (int e = tid; e < S * L; e += kThreads) {
            const int r = e & (S - 1), l = e / S;
            if (r < ns)
                cp_async4(dst + r * dr + l * dl, src + r * si + (long long)l * sl);
        }
    } else {                                       // l contiguous: l fastest
        if (aligned && sl == 1 && (si & 3) == 0 && dl == 1 && (dr & 3) == 0
            && (L & 3) == 0) {
            for (int r = 0; r < ns; ++r)
                for (int l = tid * 4; l < L; l += kThreads * 4)
                    cp_async16(dst + r * dr + l, src + r * si + l);
            return;
        }
        for (int r = 0; r < ns; ++r)
            for (int l = tid; l < L; l += kThreads)
                cp_async4(dst + r * dr + l * dl, src + r * si + (long long)l * sl);
    }
}

// The staged route: CTA x owns table rows [S x, S x + S) and every
// point. Shared memory holds the strip's index plane and two table
// buffers; channel c + 1's table copies in while channel c gathers and
// stores.
template <int C, int S>
__global__ void __launch_bounds__(kThreads)
rowwise_staged_kernel(const int* __restrict__ idx, Args a, int N, int T,
                      int P, int i_fast)
{
    constexpr int kLanesJ = kThreads / S;          // lanes along the points j
    extern __shared__ float stage[];   // [S x P] index, 2 x [S x T] tables
    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * S;
    const int ns = min(S, N - i0);                 // rows of this strip
    const int ii = i_fast ? (tid & (S - 1)) : (tid / kLanesJ);
    const int jl = i_fast ? (tid / S) : (tid & (kLanesJ - 1));
    // element (r, t) of a staged table at r * pi + t * pt, (r, j) of the
    // staged index at r * qi + j * qj: the lanes of a warp read
    // neighbouring words of the index
    const int pi = i_fast ? 1 : T, pt = i_fast ? S : 1;
    const int qi = i_fast ? 1 : P, qj = i_fast ? S : 1;
    int* xs = reinterpret_cast<int*>(stage);
    float* buf[2] = {stage + S * P, stage + S * P + S * T};

    stage_strip<S>(stage, reinterpret_cast<const float*>(idx) + i0 * a.idx_si,
                a.idx_si, a.idx_sj, ns, P, qi, qj);
#pragma unroll
    for (int c = 0; c < C && c < 2; ++c) {
        stage_strip<S>(buf[c], a.tab[c] + i0 * a.tab_si, a.tab_si, a.tab_st,
                    ns, T, pi, pt);
        cp_async_commit();
    }
    const bool live = ii < ns;
    const int* xrow = xs + ii * qi;
    const long long orow = ((long long)i0 + ii) * a.out_si;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        if (c + 1 < C) cp_async_wait<1>(); else cp_async_wait<0>();
        __syncthreads();
        if (live) {
            const float* tab = buf[c & 1] + ii * pi;
            float* out = a.out[c] + orow;
            for (int jb = jl; jb < P; jb += kUnroll * kLanesJ) {
                int k[kUnroll];
                float v[kUnroll];
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const int j = jb + u * kLanesJ;
                    k[u] = j < P ? xrow[j * qj] : 0;
                }
#pragma unroll
                for (int u = 0; u < kUnroll; ++u)
                    v[u] = (unsigned)k[u] < (unsigned)T
                               ? tab[k[u] * pt] : __int_as_float(0x7fc00000);
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const int j = jb + u * kLanesJ;
                    if (j < P) out[j * a.out_sj] = v[u];
                }
            }
        }
        if (c + 2 < C) {
            __syncthreads();             // buffer c & 1 is free again
            stage_strip<S>(buf[c & 1], a.tab[c + 2] + i0 * a.tab_si, a.tab_si,
                        a.tab_st, ns, T, pi, pt);
            cp_async_commit();
        }
    }
}

// The direct route: CTA (x, y) owns table rows [S x, S x + S) and
// points [y band, (y + 1) band); table values come from the L2.
template <int C, int S>
__global__ void __launch_bounds__(kThreads)
rowwise_direct_kernel(const int* __restrict__ idx, Args a, int N, int T,
                      int P, int i_fast, int band)
{
    constexpr int kLanesJ = kThreads / S;          // lanes along the points j
    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * S;
    const int ii = i_fast ? (tid & (S - 1)) : (tid / kLanesJ);
    const int jl = i_fast ? (tid / S) : (tid & (kLanesJ - 1));
    if (ii >= N - i0) return;
    const int j0 = blockIdx.y * band;
    const int j1 = min(P, j0 + band);
    const long long i = (long long)i0 + ii;
    const int* xrow = idx + i * a.idx_si;
    const long long orow = i * a.out_si;
    constexpr int kStep = kUnroll * kLanesJ;
    const float* row[C];
#pragma unroll
    for (int c = 0; c < C; ++c) row[c] = a.tab[c] + i * a.tab_si;
    int next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + jl + u * kLanesJ;
        next[u] = j < j1 ? __ldg(xrow + j * a.idx_sj) : 0;
    }
    for (int jb = j0 + jl; jb < j1; jb += kStep) {
        int k[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            k[u] = next[u];
            const int j = jb + kStep + u * kLanesJ;
            next[u] = j < j1 ? __ldg(xrow + j * a.idx_sj) : 0;
        }
        float v[C][kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const bool ok = (unsigned)k[u] < (unsigned)T;
#pragma unroll
            for (int c = 0; c < C; ++c)
                v[c][u] = ok ? __ldg(row[c] + (long long)k[u] * a.tab_st)
                             : __int_as_float(0x7fc00000);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int j = jb + u * kLanesJ;
            if (j < j1) {
#pragma unroll
                for (int c = 0; c < C; ++c)
                    a.out[c][orow + j * a.out_sj] = v[c][u];
            }
        }
    }
}

template <int C, int S>
cudaError_t launch(const int* idx, const Args& a, int N, int T, int P,
                   int i_fast, int staged, int band, int smem, cudaStream_t s)
{
    const unsigned strips = (unsigned)((N + S - 1) / S);
    if (!staged) {
        const dim3 grid(strips, (unsigned)(((long long)P + band - 1) / band));
        rowwise_direct_kernel<C, S><<<grid, kThreads, 0, s>>>(idx, a, N, T, P,
                                                              i_fast, band);
        return cudaGetLastError();
    }
    // above 48 KB needs the opt-in, which holds for the current device
    // only: to the card's most, once a device
    static bool opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
        int most = 0;
        err = cudaDeviceGetAttribute(
            &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                rowwise_staged_kernel<C, S>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err != cudaSuccess) return err;
        opted_in[dev] = true;
    }
    rowwise_staged_kernel<C, S><<<strips, kThreads, smem, s>>>(idx, a, N, T, P,
                                                              i_fast);
    return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The
// caller validates: C in {1, 4}, N, T, P >= 1, the C tables (N, T),
// the index plane (N, P) int32 and the C outputs (N, P) float32 on the
// device, each addressed through the strides given (in elements), and
// passes the plan (ops/lookup.py rowwise_plan, which owns the staged
// route's shared-memory layout and its size): `i_fast` (the index plane
// is contiguous along i), the strip width (8 or 16) and either `staged`
// (with `band` = P and `smem` bytes of shared memory) or the direct
// route over bands of `band` points. A plan beyond the card's shared
// memory fails at launch and its error is returned.
extern "C" int glava_rowwise_lookup(const void* const* tabs,
                                    const void* idx, void* const* outs,
                                    int C, int N, int T, int P,
                                    long long tab_si, long long tab_st,
                                    long long idx_si, long long idx_sj,
                                    long long out_si, long long out_sj,
                                    int i_fast, int strip, int staged,
                                    int band, int smem, void* stream)
{
    if (N < 1 || T < 1 || P < 1 || band < 1
        || ((long long)P + band - 1) / band > 65535 || (staged && smem < 1))
        return (int)cudaErrorInvalidValue;
    Args a = {};
    for (int c = 0; c < C && c < kMaxC; ++c) {
        a.tab[c] = (const float*)tabs[c];
        a.out[c] = (float*)outs[c];
    }
    a.tab_si = tab_si;
    a.tab_st = tab_st;
    a.idx_si = idx_si;
    a.idx_sj = idx_sj;
    a.out_si = out_si;
    a.out_sj = out_sj;
    const int* x = (const int*)idx;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (C * 100 + strip) {
    case 108: return (int)launch<1, 8>(x, a, N, T, P, i_fast, staged, band, smem, s);
    case 116: return (int)launch<1, 16>(x, a, N, T, P, i_fast, staged, band, smem, s);
    case 408: return (int)launch<4, 8>(x, a, N, T, P, i_fast, staged, band, smem, s);
    case 416: return (int)launch<4, 16>(x, a, N, T, P, i_fast, staged, band, smem, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

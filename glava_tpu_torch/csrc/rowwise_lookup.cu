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
// `plane.T` views of (H, W) planes with no transposed copy. One thread
// per output point; consecutive threads take consecutive points along
// the dimension that is contiguous in memory (`i_fast`), so the index
// reads and output writes coalesce. The index is read once for all C
// channels. Indices must lie in [0, T); one outside reads as NaN (the
// kernel never reads outside a table).
//
// What bounds it: data movement. At 1920x1080 with C = 4 the kernel
// reads the 8.3 MB index plane and four 8.3 MB tables and writes four
// 8.3 MB outputs, ~75 MB, ~22 us at 3.35 TB/s; C = 1 moves ~25 MB,
// ~7.4 us. The table reads are data-dependent but land within a column
// of the 50 MB L2-resident planes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 4;

struct Args {
    const float* tab[kMaxC];
    float* out[kMaxC];
    long long tab_si, tab_st;      // table strides: row, element
    long long idx_si, idx_sj;      // index strides: row, point
    long long out_si, out_sj;      // output strides: row, point
};

template <int C>
__global__ void __launch_bounds__(kThreads)
rowwise_lookup_kernel(const int* __restrict__ idx, Args a, int N, int T,
                      int P, int i_fast)
{
    const long long total = (long long)N * P;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         q < total; q += stride) {
        long long i, j;
        if (i_fast) {
            i = q % N;
            j = q / N;
        } else {
            j = q % P;
            i = q / P;
        }
        const int k = __ldg(idx + i * a.idx_si + j * a.idx_sj);
        const bool ok = (unsigned)k < (unsigned)T;
        const long long src = i * a.tab_si + (long long)k * a.tab_st;
        const long long dst = i * a.out_si + j * a.out_sj;
#pragma unroll
        for (int c = 0; c < C; ++c)
            a.out[c][dst] = ok ? __ldg(a.tab[c] + src)
                               : __int_as_float(0x7fc00000);
    }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The
// caller validates: C in {1, 4}, N, T, P >= 1, the C tables (N, T),
// the index plane (N, P) int32 and the C outputs (N, P) float32 on the
// device, each addressed through the strides given (in elements).
extern "C" int glava_rowwise_lookup(const void* const* tabs,
                                    const void* idx, void* const* outs,
                                    int C, int N, int T, int P,
                                    long long tab_si, long long tab_st,
                                    long long idx_si, long long idx_sj,
                                    long long out_si, long long out_sj,
                                    int i_fast, void* stream)
{
    if (N < 1 || T < 1 || P < 1) return (int)cudaErrorInvalidValue;
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
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)N * P;
    long long blocks = (total + kThreads - 1) / kThreads;
    const long long cap = (long long)sms * 16;   // grid-stride beyond this
    if (blocks > cap) blocks = cap;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (C) {
    case 1:
        rowwise_lookup_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
            (const int*)idx, a, N, T, P, i_fast);
        break;
    case 4:
        rowwise_lookup_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(
            (const int*)idx, a, N, T, P, i_fast);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Table lookup for NVIDIA Hopper (sm_90a): out[s, p] = table[s, idx[p]].
//
// Replaces two TPU kernels of glava_tpu/ops/pallas/lookup.py:
// build_table_lookup (its pl.pallas_call in _build) and
// build_static_table_lookup (the pl.pallas_calls of
// _build_subgroup_bucket and _build_bucket). Both compute one exact
// gather from a small float32 table at an int32 index plane; the TPU
// needed lane shuffles, build-time sorting of the plane into
// coherent blocks and scalar-prefetched chunk windows only because a
// per-element gather is slow there. None of that is carried over.
//
// Layouts: table (S, T) float32 contiguous (S = 1 for a 1-D table);
// idx (P,) int32 contiguous, shared by every table row; out (S, P)
// float32 contiguous. Indices must lie in [0, T); one outside reads
// as NaN (the kernel never reads outside the table).
//
// What bounds it on the card: pure data movement. Each output costs a
// 4-byte index read and a 4-byte write to device memory, so at
// circle's 1920x1080 planes (3 x 2,073,600 points) a launch moves
// ~50 MB, ~15 us at 3.35 TB/s. The table itself is small (2 x 16384
// floats = 128 KB for circle at bufsize 16384), so every block stages
// its table row once in shared memory with coalesced loads and the
// random reads then hit shared memory instead of L2. A table of more
// than kMaxTable floats (circle from bufsize 32768, a spectrum texture
// at 65536) is read from the L2 instead (the unstaged instance). Blocks walk
// the plane grid-stride, four points a thread per step with 16-byte
// index loads and output stores when P is a multiple of 4 (and the
// buffers are 16-byte aligned), so reads
// and writes stay coalesced. The grid is sized to the blocks the card
// holds at once (the table's shared memory limits that), so each
// block stages its table once and no more. A staged table holds at
// most kMaxTable floats (192 KB of shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTable = 48 * 1024;   // floats: 192 KB of shared memory

// table[i] from shared memory (kStaged) or through the read-only path
template <bool kStaged>
__device__ __forceinline__ float fetch(const float* tab, int i, int T)
{
    if ((unsigned)i >= (unsigned)T) return __int_as_float(0x7fc00000);
    return kStaged ? tab[i] : __ldg(tab + i);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
table_lookup_kernel(const float* __restrict__ table,
                    const int* __restrict__ idx,
                    float* __restrict__ out,
                    int T, long long P)
{
    extern __shared__ float stage[];
    const float* row = table + (size_t)blockIdx.y * T;
    float* orow = out + (size_t)blockIdx.y * P;
    const float* tab = row;
    if (kStaged) {
        if ((T & 3) == 0 && ((uintptr_t)row & 15) == 0) {
            const float4* src = reinterpret_cast<const float4*>(row);
            float4* dst = reinterpret_cast<float4*>(stage);
            for (int i = threadIdx.x; i < (T >> 2); i += blockDim.x)
                dst[i] = src[i];
        } else {
            for (int i = threadIdx.x; i < T; i += blockDim.x)
                stage[i] = row[i];
        }
        __syncthreads();
        tab = stage;
    }
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if ((P & 3) == 0 && (((uintptr_t)idx | (uintptr_t)out) & 15) == 0) {
        const int4* idx4 = reinterpret_cast<const int4*>(idx);
        float4* out4 = reinterpret_cast<float4*>(orow);
        for (long long q = first; q < (P >> 2); q += stride) {
            const int4 k = __ldg(idx4 + q);
            float4 v;
            v.x = fetch<kStaged>(tab, k.x, T);
            v.y = fetch<kStaged>(tab, k.y, T);
            v.z = fetch<kStaged>(tab, k.z, T);
            v.w = fetch<kStaged>(tab, k.w, T);
            out4[q] = v;
        }
    } else {
        for (long long q = first; q < P; q += stride)
            orow[q] = fetch<kStaged>(tab, __ldg(idx + q), T);
    }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The
// caller validates: S >= 1, T >= 1, P >= 1, S <= 65535, every pointer
// a contiguous device buffer of the layout above. Tables of up to
// kMaxTable floats are staged in shared memory, larger ones read from
// the L2.
extern "C" int glava_table_lookup(const void* table, const void* idx,
                                  void* out, int S, int T, long long P,
                                  void* stream)
{
    if (T < 1) return (int)cudaErrorInvalidValue;
    const bool staged = T <= kMaxTable;
    void (*kernel)(const float*, const int*, float*, int, long long) =
        staged ? table_lookup_kernel<true> : table_lookup_kernel<false>;
    const size_t smem = staged ? (size_t)T * sizeof(float) : 0;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // blocks the card holds at once, shared among the S table rows
    const long long resident = (long long)sms * per_sm;
    const long long per_row = (resident + S - 1) / S;
    const long long needed = ((P + 3) / 4 + kThreads - 1) / kThreads;
    const long long gx = needed < per_row ? needed : per_row;
    dim3 grid((unsigned)(gx > 0 ? gx : 1), (unsigned)S);
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)table, (const int*)idx, (float*)out, T, P);
    return (int)cudaGetLastError();
}

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
// ~50 MB, ~15 us at 3.35 TB/s. The table itself is small (at most
// 2 x 16384 floats = 128 KB at the largest bufsize), so every block
// stages its table row once in shared memory with coalesced loads and
// the random reads then hit shared memory instead of L2. Blocks walk
// the plane grid-stride, four points a thread per step with 16-byte
// index loads and output stores when P is a multiple of 4 (and the
// buffers are 16-byte aligned), so reads
// and writes stay coalesced. The grid is sized to the blocks the card
// holds at once (the table's shared memory limits that), so each
// block stages its table once and no more. A table holds at most
// kMaxTable floats (192 KB of shared memory); the caller checks that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTable = 48 * 1024;   // floats: 192 KB of shared memory

__device__ __forceinline__ float fetch(const float* tab, int i, int T)
{
    return (unsigned)i < (unsigned)T ? tab[i] : __int_as_float(0x7fc00000);
}

__global__ void __launch_bounds__(kThreads)
table_lookup_kernel(const float* __restrict__ table,
                    const int* __restrict__ idx,
                    float* __restrict__ out,
                    int T, long long P)
{
    extern __shared__ float tab[];
    const float* row = table + (size_t)blockIdx.y * T;
    float* orow = out + (size_t)blockIdx.y * P;
    if ((T & 3) == 0 && ((uintptr_t)row & 15) == 0) {
        const float4* src = reinterpret_cast<const float4*>(row);
        float4* dst = reinterpret_cast<float4*>(tab);
        for (int i = threadIdx.x; i < (T >> 2); i += blockDim.x)
            dst[i] = src[i];
    } else {
        for (int i = threadIdx.x; i < T; i += blockDim.x)
            tab[i] = row[i];
    }
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if ((P & 3) == 0 && (((uintptr_t)idx | (uintptr_t)out) & 15) == 0) {
        const int4* idx4 = reinterpret_cast<const int4*>(idx);
        float4* out4 = reinterpret_cast<float4*>(orow);
        for (long long q = first; q < (P >> 2); q += stride) {
            const int4 k = __ldg(idx4 + q);
            float4 v;
            v.x = fetch(tab, k.x, T);
            v.y = fetch(tab, k.y, T);
            v.z = fetch(tab, k.z, T);
            v.w = fetch(tab, k.w, T);
            out4[q] = v;
        }
    } else {
        for (long long q = first; q < P; q += stride)
            orow[q] = fetch(tab, __ldg(idx + q), T);
    }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The
// caller validates: S >= 1, 1 <= T <= kMaxTable, P >= 1, S <= 65535,
// every pointer a contiguous device buffer of the layout above.
extern "C" int glava_table_lookup(const void* table, const void* idx,
                                  void* out, int S, int T, long long P,
                                  void* stream)
{
    if (T < 1 || T > kMaxTable) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)T * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            table_lookup_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, table_lookup_kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // blocks the card holds at once, shared among the S table rows
    const long long resident = (long long)sms * per_sm;
    const long long per_row = (resident + S - 1) / S;
    const long long needed = ((P + 3) / 4 + kThreads - 1) / kThreads;
    const long long gx = needed < per_row ? needed : per_row;
    dim3 grid((unsigned)(gx > 0 ? gx : 1), (unsigned)S);
    table_lookup_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)table, (const int*)idx, (float*)out, T, P);
    return (int)cudaGetLastError();
}

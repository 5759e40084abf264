// Latency probes for the smooth scan's walks
// (glava_tpu_torch/csrc/smooth_scan.cu): one thread runs dependent
// chains of n steps of one operation each, timed with clock64(), so a
// step's cycles are the operation's latency on the card. Not a kernel
// of the package: scripts/torch_smooth_stamps.py builds and runs it to
// give the walks' chain floors.
//
// Steps (cycles[k], a step each):
//   0 float64 add            1 float64 multiply       2 float64 fma
//   3 a float64 multiply, then float64 -> float32 -> float64 (the two
//     conversions, which alone the compiler would fold)
//   4 the fast walk's longest recurrence, three bins long: v to float64,
//     three float64 adds (T, then R), a multiply (1 / c), to float32,
//     two float32 fmas (the next two bins' chain)
//   5 float32 fma (the fast walk's chain, a step a bin)
//   6 float32 IEEE division
//   7 the exact walk's float chain: s -= float64(float32(s + e) / c)
//   8 a shared-memory store then load of one float64, and an add
//   9 a load from global memory that hits L1 (a pointer chase)

#include <cuda_runtime.h>

namespace {

constexpr int kProbes = 10;

// make the value computed before the next clock64() (volatile asm
// statements keep their order)
#define DONE_D(x) asm volatile("" ::"d"(x))
#define DONE_F(x) asm volatile("" ::"f"(x))
#define DONE_I(x) asm volatile("" ::"r"(x))

__global__ void chain_latency_kernel(const double* __restrict__ in,
                                     const int* nxt, double* sink,
                                     long long* cycles, int n)
{
    __shared__ double cell[32];
    const double b = in[0], e = in[1], inv = in[2];
    const float fb = (float)in[3], fc = (float)in[4];
    double a = in[5];
    float f = (float)in[5];
    long long t[kProbes + 1];
    int k = 0;
    DONE_D(a);
    DONE_D(b);
    DONE_D(e);
    DONE_D(inv);
    DONE_F(f);
    DONE_F(fb);
    DONE_F(fc);
    t[k++] = clock64();
#pragma unroll 16
    for (int i = 0; i < n; ++i) a = a + b;
    DONE_D(a);
    t[k++] = clock64();
#pragma unroll 16
    for (int i = 0; i < n; ++i) a = a * b;
    DONE_D(a);
    t[k++] = clock64();
#pragma unroll 16
    for (int i = 0; i < n; ++i) a = fma(a, b, e);
    DONE_D(a);
    t[k++] = clock64();
#pragma unroll 16
    for (int i = 0; i < n; ++i) a = (double)(float)(a * b);
    DONE_D(a);
    t[k++] = clock64();
#pragma unroll 16
    for (int i = 0; i < n; ++i) {
        const float g = (float)(((((double)f + e) + b) + e) * inv);
        f = fmaf(fmaf(f, 0.25f, g), 0.5f, g);    // stays near 9
    }
    DONE_F(f);
    t[k++] = clock64();
#pragma unroll 16
    for (int i = 0; i < n; ++i) f = fmaf(f, fb, fc);
    DONE_F(f);
    t[k++] = clock64();
#pragma unroll 16
    for (int i = 0; i < n; ++i) f = __fdiv_rn(f, fc);
    DONE_F(f);
    t[k++] = clock64();
#pragma unroll 16
    for (int i = 0; i < n; ++i) a = a - (double)__fdiv_rn((float)(a + e), fc);
    DONE_D(a);
    t[k++] = clock64();
    volatile double* vc = cell;
    vc[threadIdx.x] = a;
#pragma unroll 16
    for (int i = 0; i < n; ++i) vc[threadIdx.x] = vc[threadIdx.x] + b;
    t[k++] = clock64();
    int idx = (int)in[6];
#pragma unroll 16
    for (int i = 0; i < n; ++i) idx = nxt[idx];
    DONE_I(idx);
    t[k++] = clock64();
    sink[0] = a + (double)f + vc[threadIdx.x] + (double)idx;
    for (int j = 0; j < kProbes; ++j) cycles[j] = t[j + 1] - t[j];
}

}  // namespace

// in: 7 float64 (b, e, inv, fb, fc, a0, idx0); nxt: int32 indices, each
// pointing at a valid index; sink: 1 float64; cycles: kProbes int64, the
// cycles of n steps of each chain. Returns a CUDA error code.
extern "C" int glava_chain_latency(const void* in, const void* nxt,
                                   void* sink, void* cycles, int n,
                                   void* stream)
{
    if (n < 1) return (int)cudaErrorInvalidValue;
    chain_latency_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (const double*)in, (const int*)nxt, (double*)sink,
        (long long*)cycles, n);
    return (int)cudaGetLastError();
}

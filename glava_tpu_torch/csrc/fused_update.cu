// Fused spectrum update for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel glava_tpu/ops/pallas/fused.py:
// build_fused_update_inc (its pl.pallas_call). One CTA owns one row
// (one stream x uniform) and, for that row, computes
//
//   1. x = pcm * pcm_window(n); re = x[0::2], im = x[1::2]  (m = n/2)
//   2. the forward complex DFT of length m, natural bin order
//      (iterative radix-2, decimation in time), in float64 over a
//      float64 twiddle table, rounded to float32 at the end
//   3. log(|.|+1)/3 on re and im separately, times the boost
//      max(j/n * fft_scale + 1 - fft_cutoff, 1) over the interleaved
//      float index j, clamped to [0, 1]
//   4. gravity: clip(max(grav, spec) - g, 0, 1), written IN PLACE
//   5. that value into the row's ring slot of hist, IN PLACE (the
//      other F-1 slots are only read)
//   6. avg = clip(sum_f w_age[(slot - f) mod F] * hist[f], 0, 1),
//      summed in f order into a separate output
//
// Layouts (all float32, contiguous): pcm (B, n); grav, avg (B, 2, m);
// hist (B, F, 2, m); slot (B,) int32; fft_scale, fft_cutoff, g (B,).
//
// What bounds it on the card: at the shipped size (n = 4096, 2 rows
// per frame, F = 6) the whole launch touches ~0.2 MB of history and a
// few KB of audio, far below what the card moves in a microsecond, so
// the kernel is bound by latency, not bytes: the launch, and inside
// each CTA the FFT's barriers and the epilogue's chain of dependent
// global accesses (each thread walks 16 floats of its row). On an
// H100 SXM at 700 W it takes ~30 us of device time at 2 rows and about
// the same at 128 rows, the rows running side by side on their own
// SMs. With many more rows (streams) it becomes bound by device
// memory: each row reads its F-1 untouched history planes (2m floats
// each) once and writes one, ~100 KB a row at n = 4096, so ~1000 rows
// take ~30 us at 3.35 TB/s. The design keeps every intermediate (the m
// complex values, the spectrum) in shared memory and registers, so
// device memory sees only those history planes, the gravity row, the
// audio row and the average.
//
// Why float64: a float32 FFT's rounding error is absolute, about
// eps * log2(m) * rms|X|, and the boost (up to ~20 for fft_scale 20)
// multiplies it into the spectrum; two correct float32 FFTs then
// differ by more than the 2e-5 spectrum tolerance from n = 4096 up.
// In float64 both this kernel and the plain version (complex128 FFT)
// produce the correctly rounded float32 spectrum, so they agree to an
// ulp at every n. The FFT is a small share of the work (see above), so
// the float64 rate of the card does not bound the kernel.
//
// Shared memory: m complex doubles, 16m bytes (32 KB at n = 4096,
// 128 KB at n = 16384, above the 48 KB default, hence the attribute
// below). Every power-of-two n from 256 to 16384 is taken.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const float* __restrict__ pcm,
                    const float* __restrict__ window,
                    const double2* __restrict__ twiddle,
                    const float* __restrict__ age_w,
                    const int* __restrict__ slot,
                    const float* __restrict__ fft_scale,
                    const float* __restrict__ fft_cutoff,
                    const float* __restrict__ gravity_g,
                    float* __restrict__ grav,
                    float* __restrict__ hist,
                    float* __restrict__ avg,
                    int n, int log2m, int F)
{
    extern __shared__ double2 buf[];
    const int m = n >> 1;
    const int row = blockIdx.x;
    const float* x = pcm + (size_t)row * n;

    // window + packed split, stored in bit-reversed order
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const float re = x[2 * i] * window[2 * i];
        const float im = x[2 * i + 1] * window[2 * i + 1];
        buf[__brev((unsigned)i) >> (32 - log2m)] = make_double2(re, im);
    }
    __syncthreads();

    // radix-2 butterflies; twiddle[j] = exp(-2 pi i j / m), j < m/2
    for (int s = 0; s < log2m; ++s) {
        const int half = 1 << s;
        const int stride = m >> (s + 1);
        for (int t = threadIdx.x; t < (m >> 1); t += blockDim.x) {
            const int k = t & (half - 1);
            const int i = ((t >> s) << (s + 1)) + k;
            const int j = i + half;
            const double2 w = twiddle[k * stride];
            const double2 a = buf[i];
            const double2 b = buf[j];
            const double br = b.x * w.x - b.y * w.y;
            const double bi = b.x * w.y + b.y * w.x;
            buf[i] = make_double2(a.x + br, a.y + bi);
            buf[j] = make_double2(a.x - br, a.y - bi);
        }
        __syncthreads();
    }

    const float fs = fft_scale[row];
    const float base = 1.0f - fft_cutoff[row];
    const float g = gravity_g[row];
    int sl = slot[row] % F;
    if (sl < 0) sl += F;
    const size_t plane = (size_t)2 * m;
    float* grow = grav + (size_t)row * plane;
    float* hrow = hist + (size_t)row * F * plane;
    float* arow = avg + (size_t)row * plane;

    // e walks the (2, m) planes: e < m is re[e], e >= m is im[e - m]
    for (int e = threadIdx.x; e < 2 * m; e += blockDim.x) {
        const int c = e >= m;
        const int k = e - c * m;
        const double2 X = buf[k];
        const float v = (float)(c ? X.y : X.x);
        const float jn = (float)(2 * k + c) / (float)n;
        float spec = logf(fabsf(v) + 1.0f) / 3.0f;
        spec = spec * fmaxf(jn * fs + base, 1.0f);
        spec = fminf(fmaxf(spec, 0.0f), 1.0f);
        float gv = fmaxf(grow[e], spec) - g;
        gv = fminf(fmaxf(gv, 0.0f), 1.0f);
        grow[e] = gv;
        hrow[(size_t)sl * plane + e] = gv;
        float acc = 0.0f;
        for (int f = 0; f < F; ++f) {
            int age = sl - f;
            if (age < 0) age += F;
            const float h = (f == sl) ? gv : hrow[(size_t)f * plane + e];
            acc += age_w[age] * h;
        }
        arow[e] = fminf(fmaxf(acc, 0.0f), 1.0f);
    }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The
// caller validates shapes: n a power of two in [256, 16384], B >= 1,
// F >= 1, every pointer a contiguous device buffer of the layout above.
extern "C" int glava_fused_update(
    const void* pcm, const void* window, const void* twiddle,
    const void* age_w, const void* slot, const void* fft_scale,
    const void* fft_cutoff, const void* gravity_g,
    void* grav, void* hist, void* avg,
    int B, int n, int F, void* stream)
{
    const int m = n >> 1;
    int log2m = 0;
    while ((1 << log2m) < m) ++log2m;
    const size_t smem = (size_t)m * sizeof(double2);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fused_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    fused_update_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)pcm, (const float*)window, (const double2*)twiddle,
        (const float*)age_w, (const int*)slot, (const float*)fft_scale,
        (const float*)fft_cutoff, (const float*)gravity_g,
        (float*)grav, (float*)hist, (float*)avg, n, log2m, F);
    return (int)cudaGetLastError();
}

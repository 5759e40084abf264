// The smooth transform for NVIDIA Hopper (sm_90a): a log-scale
// neighbourhood average of the leading asz bins of each row, walked
// bin by bin IN PLACE (glava/render.c:694-718).
//
// Not the port of a Pallas kernel: the counterpart of the lax.scan at
// glava_tpu/ops/transforms.py:145 (smooth_transform), which the JAX
// package runs on the device as one program, where an eager torch
// loop would issue some five launches a bin. The plain version is
// ops/smooth.py:smooth_transform_plain.
//
// Semantics (kept exactly): bin t becomes the mean of the nonzero
// entries of the window [lo_t, hi_t] of the buffer as it stands, so
// entries below t are already smoothed and the others are not; a NaN
// entry counts (NaN != 0) and makes the mean NaN; an empty count gives
// 0/0 = NaN (bin 0 always); at the end NaN -> 0, +-inf pass through.
//
// Layouts: x and out (rows, sz) float32 contiguous; bounds (asz, 2)
// int32, each bin's inclusive window, built on the host in float64 as
// the JAX package builds its mask (ops/smooth.py:smooth_bounds). For
// t >= 1 the host has checked 1 <= lo_t <= t <= hi_t < sz.
//
// What bounds it: neither bytes nor operations. The function moves
// 8 bytes a bin and does O(1) work a bin, but bin t depends on bin
// t - 1, so each row is a chain of asz dependent steps: latency. The
// design keeps that chain as short as it can be:
//
// * A window's content is a difference of prefix statistics (the
//   finite sum in float64, the nonzero count, and the NaN, +inf and
//   -inf counts). Its original part [t, hi_t] is P[hi_t + 1] - P[t],
//   with P the prefix of the input row, which all 256 threads build
//   first (a block scan of per-thread chunks). Its smoothed part
//   [lo_t, t) is S[t] - S[lo_t], with S the prefix of the smoothed
//   bins, which the walk extends by one entry a bin and keeps.
// * One thread walks the bins. Bin t's operands (its window bounds, two
//   P entries and one S entry) are loaded during bin t - 1 (the bounds
//   during bin t - 2), so no load waits in the chain; what is left in
//   it is the mean (two float64 adds, the conversions and a float32
//   division) and one float64 add into S.
// * P and S live in shared memory when they fit (24 bytes an entry,
//   sz + asz + 2 entries: sz 4096 at any ratio), else in a device
//   scratch buffer, through L1.
//
// Counts are integers, so NaN and inf are tracked exactly; the float64
// sums lose ~1e-16 of a prefix's magnitude per difference, far below
// the float32 mean. The mean is float32(sum) / float32(count), as the
// JAX step divides its float32 sums. Rows run in parallel, one a CTA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEntryBytes = 24;   // one prefix entry: a double and 4 ints
constexpr int kMaxDevices = 64;   // per-device shared-memory opt-ins

// the statistics of a run of entries
struct Stat {
    double sum;     // of the finite entries
    int cnt;        // nonzero entries (NaN included)
    int nan, pinf, ninf;
};

__device__ __forceinline__ Stat zero_stat() { return {0.0, 0, 0, 0, 0}; }

__device__ __forceinline__ Stat stat_of(float v)
{
    return {isfinite(v) ? (double)v : 0.0, v != 0.0f, isnan(v),
            v == __int_as_float(0x7f800000), v == __int_as_float(0xff800000)};
}

__device__ __forceinline__ Stat operator+(const Stat& a, const Stat& b)
{
    return {a.sum + b.sum, a.cnt + b.cnt, a.nan + b.nan, a.pinf + b.pinf,
            a.ninf + b.ninf};
}

__device__ __forceinline__ Stat operator-(const Stat& a, const Stat& b)
{
    return {a.sum - b.sum, a.cnt - b.cnt, a.nan - b.nan, a.pinf - b.pinf,
            a.ninf - b.ninf};
}

__device__ __forceinline__ Stat shfl_up(const Stat& s, int delta)
{
    return {__shfl_up_sync(0xffffffffu, s.sum, delta),
            __shfl_up_sync(0xffffffffu, s.cnt, delta),
            __shfl_up_sync(0xffffffffu, s.nan, delta),
            __shfl_up_sync(0xffffffffu, s.pinf, delta),
            __shfl_up_sync(0xffffffffu, s.ninf, delta)};
}

// the mean of the nonzero entries of a window
__device__ __forceinline__ float mean(const Stat& c)
{
    if (c.cnt == 0 || c.nan > 0 || (c.pinf > 0 && c.ninf > 0))
        return __int_as_float(0x7fc00000);
    if (c.pinf > 0) return __int_as_float(0x7f800000);
    if (c.ninf > 0) return __int_as_float(0xff800000);
    return (float)c.sum / (float)c.cnt;
}

// n prefix entries, field by field (the sums first, 8-byte aligned);
// a view starts at entry `first` of them
struct Table {
    double* sum;
    int* cnt;
    int* nan;
    int* pinf;
    int* ninf;

    __device__ Table(char* base, int n, int first)
    {
        sum = (double*)base + first;
        int* ints = (int*)((double*)base + n) + first;
        cnt = ints;
        nan = ints + n;
        pinf = ints + 2 * n;
        ninf = ints + 3 * n;
    }
    __device__ __forceinline__ Stat get(int k) const
    {
        return {sum[k], cnt[k], nan[k], pinf[k], ninf[k]};
    }
    __device__ __forceinline__ void put(int k, const Stat& s) const
    {
        sum[k] = s.sum;
        cnt[k] = s.cnt;
        nan[k] = s.nan;
        pinf[k] = s.pinf;
        ninf[k] = s.ninf;
    }
};

// the block-wide exclusive prefix of each thread's `v`
__device__ Stat block_exclusive_scan(const Stat& v)
{
    __shared__ Stat warp_total[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    Stat inc = v;
    for (int d = 1; d < 32; d <<= 1) {
        const Stat o = shfl_up(inc, d);
        if (lane >= d) inc = inc + o;
    }
    Stat exc = shfl_up(inc, 1);
    if (lane == 0) exc = zero_stat();
    if (lane == 31) warp_total[warp] = inc;
    __syncthreads();
    for (int w = 0; w < warp; ++w) exc = warp_total[w] + exc;
    return exc;
}

__global__ void __launch_bounds__(kThreads)
smooth_scan_kernel(const float* __restrict__ x, const int2* __restrict__ bounds,
                   float* __restrict__ out, char* scratch, int sz, int asz,
                   int staged)
{
    extern __shared__ double stage[];
    const float* src = x + (size_t)blockIdx.x * sz;
    float* dst = out + (size_t)blockIdx.x * sz;
    const int n = sz + asz + 2;
    char* base = staged ? (char*)stage
                        : scratch + (size_t)blockIdx.x * n * kEntryBytes;
    const Table P(base, n, 0);          // P[k]: the input's [0, k)
    const Table S(base, n, sz + 1);     // S[k]: the smoothed bins [0, k)

    // P by a block scan of per-thread chunks; the bins the walk does
    // not reach are written here, NaN -> 0
    const int per = (sz + kThreads - 1) / kThreads;
    const int begin = min((int)threadIdx.x * per, sz);
    const int end = min(begin + per, sz);
    Stat run = zero_stat();
    for (int i = begin; i < end; ++i) {
        const float v = src[i];
        run = run + stat_of(v);
        if (i >= asz) dst[i] = isnan(v) ? 0.0f : v;
    }
    run = block_exclusive_scan(run);
    for (int i = begin; i < end; ++i) {
        P.put(i, run);
        run = run + stat_of(src[i]);
    }
    if (begin < end && end == sz) P.put(sz, run);
    __syncthreads();
    if (threadIdx.x != 0 || asz < 1) return;

    // the walk; bin 0 is an empty window: NaN
    Stat cur = zero_stat();             // S[t] at bin t
    S.put(0, cur);
    cur = cur + stat_of(__int_as_float(0x7fc00000));
    S.put(1, cur);
    dst[0] = 0.0f;
    if (asz < 2) return;
    const int last = asz - 1;
    int2 w = bounds[1];
    int2 wn = bounds[min(2, last)];
    Stat pt = P.get(1), phi = P.get(w.y + 1);
    Stat slo = w.x == 1 ? cur : S.get(w.x);
    for (int t = 1; t < asz; ++t) {
        // bin t + 1's operands (dummies past the last bin); its lo is at
        // most t + 1: S[t + 1] is this bin's result, S[t] is cur, and
        // any earlier entry is stored
        const int2 wnn = bounds[min(t + 2, last)];
        const Stat ptn = P.get(min(t + 1, last));
        const Stat phin = P.get(wn.y + 1);
        Stat slon = wn.x == t ? cur : (wn.x > t ? zero_stat() : S.get(wn.x));

        const float v = mean((cur - slo) + (phi - pt));
        dst[t] = isnan(v) ? 0.0f : v;
        cur = cur + stat_of(v);
        S.put(t + 1, cur);

        if (wn.x > t) slon = cur;
        w = wn;
        wn = wnn;
        pt = ptn;
        phi = phin;
        slo = slon;
    }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The
// caller validates: rows >= 1, 1 <= asz <= sz, contiguous device
// buffers of the layouts above, the windows' bounds, and staged only
// when (sz + asz + 2) entries of 24 bytes fit in shared memory; else
// scratch holds that many for every row.
extern "C" int glava_smooth_scan(const void* x, const void* bounds, void* out,
                                 void* scratch, int rows, int sz, int asz,
                                 int staged, void* stream)
{
    if (rows < 1 || sz < 1 || asz < 0 || asz > sz || (!staged && !scratch))
        return (int)cudaErrorInvalidValue;
    const size_t smem = staged ? (size_t)(sz + asz + 2) * kEntryBytes : 0;
    // the opt-in above 48 KB holds for the current device only: raised
    // on each device to the largest size asked for there
    static size_t opted[kMaxDevices] = {};
    if (smem > 48 * 1024) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e != cudaSuccess) return (int)e;
        if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
        if (smem > opted[dev]) {
            e = cudaFuncSetAttribute(
                smooth_scan_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
            opted[dev] = smem;
        }
    }
    smooth_scan_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const int2*)bounds, (float*)out, (char*)scratch, sz,
        asz, staged);
    return (int)cudaGetLastError();
}

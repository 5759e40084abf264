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
// design takes everything it can off that chain. Two walks, both this
// kernel's, one CTA a row:
//
// * The fast walk. A smoothed bin that is not exactly 0 counts in every
//   later window (a NaN is nonzero to the C check), so while no
//   smoothed bin comes out 0, the count of bin t's window is known from
//   the input alone: c_t = (t - lo_t) + nonzero inputs in [t, hi_t]. So
//   are its original part's sum R_t and whether that part holds a NaN.
//   All 256 threads build these, 1/c_t with them, from the input's
//   prefix first. One thread then walks (fast_walk): the window's two
//   newest bins are float32 fma terms on the chain, the older ones a
//   float64 running sum beside it, so the step from v_{t-1} to v_t is
//   one float32 fma; the rest is software-pipelined a bin or two
//   ahead, since a warp runs its instructions in order. A NaN in a
//   window is an integer chain beside the float one: the last NaN bin
//   >= lo_t.
//   After the walk all threads find the first bin that came out
//   exactly 0 (zero_scan).
// * The exact walk, the prefix-statistics walk of the design before:
//   each window a difference of prefix statistics (the finite sum in
//   float64, the nonzero, NaN, +inf and -inf counts), its mean a
//   float32 division. It takes the rest of a row from the first bin
//   whose window the fast walk cannot count: after a bin that came out
//   exactly 0 while finite, or the first window that holds an input
//   +-inf (or from the bin the caller names: ops/smooth.py sends the
//   whole row where lo grows by 2 somewhere, at distance ~0). The state
//   up to there is exact, so the row resumes: all threads rebuild the
//   statistics of the input and of the bins done, then one thread
//   walks on.
//
// Every table lives in shared memory when it fits (sz 4096 at any
// ratio), else in a device scratch buffer of the same layout, through
// L1; there the fast walk prefetches its tables' lines into L1 a few
// dozen bins ahead. The float64 sums lose ~1e-16 of a prefix's
// magnitude per difference, far below the float32 mean.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEntryBytes = 24;   // one exact-walk prefix entry
constexpr int kMaxDevices = 64;   // per-device shared-memory opt-ins
constexpr unsigned kNanFlag = 0x80000000u;
constexpr int kAhead = 64;        // bins the fast walk prefetches ahead

// bring the line of global address p into L1 without waiting for it
__device__ __forceinline__ void prefetch_l1(const void* p)
{
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

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
    __syncthreads();        // warp_total is reused by the next scan
    return exc;
}

// P[k], the statistics of src[0, k) for k in [0, n], into `tab` by a
// block scan of per-thread chunks (the exact walk's rebuild, off the
// fast path)
__device__ __forceinline__ void prefix_of(const float* __restrict__ src, int n,
                                          const Table& tab)
{
    const int per = (n + kThreads - 1) / kThreads;
    const int begin = min((int)threadIdx.x * per, n);
    const int end = min(begin + per, n);
    Stat run = zero_stat();
    for (int i = begin; i < end; ++i) run = run + stat_of(src[i]);
    run = block_exclusive_scan(run);
    // entries [begin, end), and n by the chunk that ends there
    const int stop = begin < end && end == n ? n + 1 : end;
    for (int i = begin; i < stop; ++i) {
        tab.put(i, run);
        if (i < end) run = run + stat_of(src[i]);
    }
}

// a run's finite sum, nonzero and NaN counts (the fast walk's prefix)
struct Sum3 {
    double s;
    int c, n;
};

__device__ __forceinline__ Sum3 operator+(const Sum3& a, const Sum3& b)
{
    return {a.s + b.s, a.c + b.c, a.n + b.n};
}

__device__ __forceinline__ Sum3 shfl_up(const Sum3& v, int d)
{
    return {__shfl_up_sync(0xffffffffu, v.s, d),
            __shfl_up_sync(0xffffffffu, v.c, d),
            __shfl_up_sync(0xffffffffu, v.n, d)};
}

__device__ __forceinline__ Sum3 shfl_idx(const Sum3& v, int lane)
{
    return {__shfl_sync(0xffffffffu, v.s, lane),
            __shfl_sync(0xffffffffu, v.c, lane),
            __shfl_sync(0xffffffffu, v.n, lane)};
}

// the exclusive prefix of n elements and their total at n, by warps:
// warp w scans a contiguous segment 32 elements at a time (coalesced
// loads, one shared-memory bank a lane), after its carry-in from the
// warps before. kInput: the elements are the statistics of src[i] into
// psum, pcnt and pnan, and on the way dst[i] = src[i] (NaN -> 0) from
// asz on and the first +-inf from index 1 into *first_inf; else they
// are vals[i], replaced by their prefix sums (vals holds n + 1 entries)
template <bool kInput>
__device__ __forceinline__ void segment_prefix(
    const float* __restrict__ src, double* vals, int n, double* psum,
    int* pcnt, int* pnan, float* __restrict__ dst, int asz, int* first_inf)
{
    __shared__ Sum3 warp_total[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int seg = ((n + kWarps - 1) / kWarps + 31) & ~31;
    const int b0 = min(warp * seg, n), b1 = min(b0 + seg, n);
    auto elem = [&](int i) -> Sum3 {
        if (!kInput) return {vals[i], 0, 0};
        const float v = src[i];
        return {isfinite(v) ? (double)v : 0.0, v != 0.0f, isnan(v)};
    };
    Sum3 acc = {0.0, 0, 0};
    for (int i = b0 + lane; i < b1; i += 32) {
        acc = acc + elem(i);
        if (kInput) {
            const float v = src[i];
            if (i >= asz) dst[i] = isnan(v) ? 0.0f : v;
            if (i >= 1 && isinf(v)) atomicMin(first_inf, i);
        }
    }
    for (int d = 16; d > 0; d >>= 1) {
        acc = acc + Sum3{__shfl_xor_sync(0xffffffffu, acc.s, d),
                         __shfl_xor_sync(0xffffffffu, acc.c, d),
                         __shfl_xor_sync(0xffffffffu, acc.n, d)};
    }
    if (lane == 0) warp_total[warp] = acc;
    __syncthreads();
    Sum3 carry = {0.0, 0, 0};
    for (int w = 0; w < warp; ++w) carry = carry + warp_total[w];
    for (int base = b0; base < b1; base += 32) {
        const int i = base + lane;
        const Sum3 e = i < b1 ? elem(i) : Sum3{0.0, 0, 0};
        Sum3 inc = e;
        for (int d = 1; d < 32; d <<= 1) {
            const Sum3 o = shfl_up(inc, d);
            if (lane >= d) inc = inc + o;
        }
        Sum3 exc = shfl_up(inc, 1);
        if (lane == 0) exc = {0.0, 0, 0};
        exc = carry + exc;
        if (i < b1) {
            if (kInput) {
                psum[i] = exc.s;
                pcnt[i] = exc.c;
                pnan[i] = exc.n;
            } else {
                vals[i] = exc.s;
            }
        }
        carry = carry + shfl_idx(inc, 31);
    }
    // the total, by the warp whose segment ends at n (thread 0 if none)
    if (lane == 0 && ((b0 < b1 && b1 == n) || (n == 0 && warp == 0))) {
        if (kInput) {
            psum[n] = carry.s;
            pcnt[n] = carry.c;
            pnan[n] = carry.n;
        } else {
            vals[n] = carry.s;
        }
    }
}

// the exact walk of bins [h, asz): S[h] holds the statistics of the
// smoothed bins [0, h), P those of the input; each bin's mean into ys
__device__ __forceinline__ void exact_walk(const Table& P, const Table& S,
                           const int2* __restrict__ bounds, float* ys, int h,
                           int asz)
{
    const int last = asz - 1;
    Stat cur = S.get(h);                // S[t] at bin t
    int2 w = bounds[h];
    int2 wn = bounds[min(h + 1, last)];
    Stat pt = P.get(h), phi = P.get(w.y + 1);
    Stat slo = w.x == h ? cur : S.get(w.x);
    for (int t = h; t < asz; ++t) {
        // bin t + 1's operands (dummies past the last bin); its lo is at
        // most t + 1: S[t + 1] is this bin's result, S[t] is cur, and
        // any earlier entry is stored
        const int2 wnn = bounds[min(t + 2, last)];
        const Stat ptn = P.get(min(t + 1, last));
        const Stat phin = P.get(wn.y + 1);
        Stat slon = wn.x == t ? cur : (wn.x > t ? zero_stat() : S.get(wn.x));
        const Stat win = (cur - slo) + (phi - pt);
        const float v = mean(win);
        ys[t] = v;
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

// one bin's operands of the fast walk, built by all threads first
struct alignas(16) BinA {
    double r;       // R_t, the finite sum of the inputs [t, hi_t]
    double iv;      // 1 / c_t (0 where c_t is 0)
};
struct alignas(16) BinB {
    unsigned lf;    // lo_t and the flags below
    float a1;       // float32(1 / c_t) where lo_t <= t - 1, else 0
    float a2;       // float32(1 / c_t) where lo_t <= t - 2, else 0
    unsigned pad;
};
constexpr unsigned kAddFlag = 0x40000000u;   // T_t holds bin t - 3
constexpr unsigned kDropFlag = 0x20000000u;  // T_t lost bin lo_{t-1}
constexpr unsigned kLoMask = 0x1fffffffu;

// the fast walk of bins [1, end) (ys[0] set), each bin's value into ys
// (NaN where poisoned) and the chain's value in float64 (0 there) into
// vd. Bin t's window sum is a1 v_{t-1} + a2 v_{t-2} + T_t + R_t, with a1
// = [lo_t <= t - 1], a2 = [lo_t <= t - 2] and T_t the bins [lo_t, t -
// 3], a float64 running sum that gains bin t - 3 and loses bin
// lo_{t-1} as the window moves (lo never falls and grows by at most 1
// a bin: every bin is dropped once, in order; both flags are the bin's
// own, from the lo's alone). So the chain is one float32 fma a bin,
//     v_t = fmaf(v_{t-1}, a1 / c_t, fmaf(v_{t-2}, a2 / c_t,
//                                        float32((T_t + R_t) / c_t)))
// (every term 0 for a NaN bin, whose finite part is 0), within 2 ulp of
// the rounded mean. A warp runs its instructions in order, so the step
// of bin t also builds bin t + 1's inner fma and NaN class and bin t +
// 2's T and float32(G), and every load it starts is used two steps
// later (so the unrolled loop keeps each in place, with no register
// moves): bin t + 3's flags, bin t + 4's operands and the bin T_{t+4}
// drops, and lo_{t+5}, that load's address. Unrolled 4 times it ran 12%
// faster than twice on an H100 (chip_smoke.py --smooth-ab).
template <bool kStaged>
__device__ __forceinline__ void fast_walk(const BinA* __restrict__ ra,
                                          const BinB* __restrict__ rb,
                                          float* __restrict__ ys,
                                          double* __restrict__ vd, int end,
                                          int asz)
{
    const int last = asz - 1;
    auto at = [last](int i) { return min(i, last); };
    vd[0] = 0.0;                        // bin 0 is NaN: its finite part
    int lastnan = 0;                    // the last NaN bin below t
    float v1 = 0.0f;                    // bin t - 1 (0 if NaN)
    double vd1 = 0.0;                   // the same in float64
    // bin t = 1 (lo_1 = 1: no smoothed bin in its window), its chain's
    // terms and NaN class
    const BinA a_1 = ra[at(1)];
    bool pois = rb[at(1)].lf & kNanFlag;
    float A1 = 0.0f;
    float inner = pois ? 0.0f : (float)(a_1.r * a_1.iv);
    // bin t + 1's float32(G) (T_2 = 0) and T_{t+1}
    const BinA a_2 = ra[at(2)];
    float gf1 = (float)(a_2.r * a_2.iv);
    double T = 0.0;
    // what step t uses, loaded two steps before it (the first two by
    // hand): bin t + 1's flags; bin t + 2's operands and the bin T_{t+2}
    // drops (none before bin 5); lo_{t+3}
    BinB f1 = rb[at(2)], f1n = rb[at(3)];
    BinA o2 = ra[at(3)], o2n = ra[at(4)];
    BinB g2 = rb[at(3)], g2n = rb[at(4)];
    double d2 = 0.0, d2n = 0.0;
    int lo3 = (int)(rb[at(4)].lf & kLoMask);
    int lo3n = (int)(rb[at(5)].lf & kLoMask);
#pragma unroll 4
    for (int t = 1; t < end; ++t) {
        const float v = fmaf(v1, A1, inner);        // the chain
        const double vdt = (double)v;
        ys[t] = pois ? __int_as_float(0x7fc00000) : v;
        vd[t] = vdt;
        // loads for step t + 2 (the drop's bin lo_{t+3} is stored: the
        // flag says lo_{t+3} <= t)
        const BinB f1l = rb[at(t + 3)];
        const BinA o2l = ra[at(t + 4)];
        const BinB g2l = rb[at(t + 4)];
        const double d2l = vd[min(lo3, t)];
        const int lo3l = (int)(rb[at(t + 5)].lf & kLoMask);
        // bin t + 1: its NaN class, chain coefficient and inner fma
        const int lo1 = (int)(f1.lf & kLoMask);
        const bool pn = (f1.lf & kNanFlag) | (pois & (lo1 <= t)) |
                        (lastnan >= lo1);
        lastnan = pois ? t : lastnan;
        const float A1n = pn ? 0.0f : f1.a1;
        const float innern = fmaf(v1, pn ? 0.0f : f1.a2, pn ? 0.0f : gf1);
        // bin t + 2: T_{t+2} gains bin t - 1 and drops bin lo_{t+1}
        T += (g2.lf & kAddFlag ? vd1 : 0.0) - (g2.lf & kDropFlag ? d2 : 0.0);
        const float gf2 = (float)((T + o2.r) * o2.iv);
        if (!kStaged) {
            // the tables in device scratch: their lines into L1 well
            // before the loads above reach them
            const int k = at(t + kAhead);
            prefetch_l1(ra + k);
            prefetch_l1(rb + k);
            prefetch_l1(vd + min(lo3 + kAhead, t));
        }
        v1 = v;
        vd1 = vdt;
        pois = pn;
        A1 = A1n;
        inner = innern;
        gf1 = gf2;
        f1 = f1n;
        f1n = f1l;
        o2 = o2n;
        o2n = o2l;
        g2 = g2n;
        g2n = g2l;
        d2 = d2n;
        d2n = d2l;
        lo3 = lo3n;
        lo3n = lo3l;
    }
}

// after the fast walk, all threads: the first bin in [1, end) whose
// exact window sum (S[t] - S[lo_t]) + R_t, in float64, is 0, or whose
// value came out 0 (not NaN), into *zero_at; S is exact up to it
__device__ __forceinline__ void zero_scan(const BinA* ra, const BinB* rb,
                                          const double* S, const float* ys,
                                          int end, int* zero_at)
{
    for (int t = 1 + threadIdx.x; t < end; t += kThreads) {
        const float v = ys[t];
        if (isnan(v)) continue;
        const double w = (S[t] - S[rb[t].lf & kLoMask]) + ra[t].r;
        if (w == 0.0 || v == 0.0f) atomicMin(zero_at, t);
    }
}

// kStaged: the tables in shared memory, every pointer to them derived
// from `stage` alone so that the compiler emits shared loads and stores
// (a pointer that may be either is generic, and slower); else in scratch
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
smooth_scan_kernel(const float* __restrict__ x, const int2* __restrict__ bounds,
                   float* __restrict__ out, char* scratch,
                   unsigned long long* __restrict__ rows_by_walk, int sz,
                   int asz, int exact_from, size_t row_bytes)
{
    extern __shared__ __align__(16) double stage[];
    __shared__ int first_inf, fast_end, zero_at;
    const float* src = x + (size_t)blockIdx.x * sz;
    float* dst = out + (size_t)blockIdx.x * sz;
    char* base = kStaged ? (char*)stage : scratch + blockIdx.x * row_bytes;
    // ys: the smoothed bins as the buffer holds them; then the walks'
    // tables, the fast walk's and later the exact walk's in one place
    const size_t bins = ((size_t)asz * 4 + 15) & ~(size_t)15;
    float* ys = (float*)base;
    char* tables = base + bins;
    BinA* ra = (BinA*)tables;
    BinB* rb = (BinB*)(ra + asz);
    double* psum = (double*)(rb + asz); // the input's prefix, then the
    int* pcnt = (int*)(psum + sz + 1);  // chain's values and their
    int* pnan = pcnt + sz + 1;          // prefix S

    if (threadIdx.x == 0) {
        first_inf = sz;
        fast_end = asz;
        zero_at = asz;
    }
    __syncthreads();
    // the bins the walks do not reach, NaN -> 0; the input's first +-inf;
    // the input's prefix
    segment_prefix<true>(src, nullptr, sz, psum, pcnt, pnan, dst, asz,
                         &first_inf);
    __syncthreads();

    // each bin's count, original sum, NaN class and T flags; the first
    // window that holds an input +-inf (hi_t is nondecreasing in t)
    for (int t = 1 + threadIdx.x; t < asz; t += kThreads) {
        const int2 b = bounds[t];
        const int lo = b.x, lo_prev = bounds[t - 1].x;
        const int c = (t - lo) + pcnt[b.y + 1] - pcnt[t];
        const double iv = c > 0 ? 1.0 / (double)c : 0.0;
        const float ivf = (float)iv;
        ra[t] = {psum[b.y + 1] - psum[t], iv};
        rb[t] = {(unsigned)lo |
                     ((pnan[b.y + 1] > pnan[t] || c == 0) ? kNanFlag : 0u) |
                     (lo <= t - 3 ? kAddFlag : 0u) |
                     (t >= 2 && lo > lo_prev && lo_prev <= t - 4 ? kDropFlag
                                                                  : 0u),
                 lo <= t - 1 ? ivf : 0.0f, lo <= t - 2 ? ivf : 0.0f, 0u};
        if (b.y >= first_inf) atomicMin(&fast_end, t);
    }
    __syncthreads();

    const int end = min(fast_end, max(exact_from, 1));
    if (threadIdx.x == 0) {
        // the fast walk of bins [1, end); bin 0 is an empty window: NaN
        ys[0] = __int_as_float(0x7fc00000);
        fast_walk<kStaged>(ra, rb, ys, psum, end, asz);
    }
    __syncthreads();
    segment_prefix<false>(nullptr, psum, end, nullptr, nullptr, nullptr,
                          nullptr, 0, nullptr);
    __syncthreads();
    zero_scan(ra, rb, psum, ys, end, &zero_at);
    __syncthreads();
    if (threadIdx.x == 0 && zero_at < end) ys[zero_at] = 0.0f;
    __syncthreads();

    // the exact walk from the first bin the fast walk cannot count
    const int h = min(end, zero_at + 1);
    if (h < asz) {
        const int n = sz + asz + 2;
        const Table P(tables, n, 0);        // P[k]: the input's [0, k)
        const Table SS(tables, n, sz + 1);  // S[k]: the smoothed [0, k)
        prefix_of(src, sz, P);
        prefix_of(ys, h, SS);
        __syncthreads();
        if (threadIdx.x == 0) exact_walk(P, SS, bounds, ys, h, asz);
        __syncthreads();
    }
    if (threadIdx.x == 0) atomicAdd(&rows_by_walk[h < asz ? 1 : 0], 1ull);
    for (int t = threadIdx.x; t < asz; t += kThreads) {
        const float v = ys[t];
        dst[t] = isnan(v) ? 0.0f : v;
    }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The
// caller validates: rows >= 1, 1 <= asz <= sz, contiguous device
// buffers of the layouts above, the windows' bounds, and staged only
// when glava_smooth_scan_bytes(sz, asz) fit in shared memory; else
// scratch holds that many for every row. rows_by_walk: two uint64
// counters, the rows the fast walk finished and those the exact walk
// finished. exact_from < asz sends every row to the exact walk from
// that bin at the latest (asz for none).
extern "C" long long glava_smooth_scan_bytes(int sz, int asz)
{
    const long long bins = ((long long)asz * 4 + 15) & ~15LL;
    const long long fast = 32LL * asz + 16LL * (sz + 1);
    const long long exact = (long long)(sz + asz + 2) * kEntryBytes;
    return (bins + (fast > exact ? fast : exact) + 15) & ~15LL;
}

extern "C" int glava_smooth_scan(const void* x, const void* bounds, void* out,
                                 void* scratch, void* rows_by_walk, int rows,
                                 int sz, int asz, int staged, int exact_from,
                                 void* stream)
{
    if (rows < 1 || sz < 1 || asz < 1 || asz > sz || !rows_by_walk ||
        (!staged && !scratch))
        return (int)cudaErrorInvalidValue;
    const size_t bytes = (size_t)glava_smooth_scan_bytes(sz, asz);
    const size_t smem = staged ? bytes : 0;
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
                smooth_scan_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
            opted[dev] = smem;
        }
    }
    auto* kernel =
        staged ? smooth_scan_kernel<true> : smooth_scan_kernel<false>;
    kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const int2*)bounds, (float*)out, (char*)scratch,
        (unsigned long long*)rows_by_walk, sz, asz, exact_from, bytes);
    return (int)cudaGetLastError();
}

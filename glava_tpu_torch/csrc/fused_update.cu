// Fused spectrum update for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel glava_tpu/ops/pallas/fused.py:
// build_fused_update_inc (its pl.pallas_call). For each row (one stream
// x uniform) it computes
//
//   1. x = pcm * pcm_window(n); re = x[0::2], im = x[1::2]  (m = n/2)
//   2. the forward complex DFT of length m, natural bin order, in
//      float64 over float64 twiddle tables, rounded to float32 at the end
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
// What bounds it on this card: latency, until the rows are many. At the
// shipped size (n 4096, F 6) a row moves ~100 KB (its F-1 untouched
// history planes read, one written, gravity, average, audio), so 2 rows
// are 0.11 us of device memory and 128 rows 6.9 us, while one CTA alone
// on a row took tens of microseconds: a chain of dependent steps (the
// audio's arrival, 11 radix-2 FFT passes behind barriers, then the
// epilogue's history reads, issued only after the FFT). The design cuts
// that chain and spreads it:
//
// * A cluster of k CTAs a row (k = m/256, 1 to 8, and 16 at n 65536,
//   where 8 CTAs would each need a 4096-point FFT, more than shared
//   memory holds; ops/fused.py fft_plan), launched with
//   cudaLaunchKernelEx and the cluster dimension (16 through the
//   non-portable cluster opt-in), so a row's work spreads over k SMs. Four-step split,
//   m = k * m2: CTA j1 loads x[j1 + k*j2] (j2 < m2) straight from the
//   audio row, runs an m2-point FFT and scales bin f2 by W_m^(j1*f2).
//   Its last FFT pass stores each bin into the shared memory of the CTA
//   that owns it (distributed shared memory, no round trip): CTA `rank`
//   owns f2 = rank*m2/k + u (u < m2/k) and, after one cluster barrier,
//   forms bins f1*m2 + f2 (f1 < k) as k-point DFTs over j1 in
//   registers. So a CTA owns k runs of m2/k bins of each plane.
// * History in flight during the FFT. One thread of each CTA issues
//   asynchronous copies into shared memory, all completing on mbarriers:
//   at the start the two twiddle tables (cp.async.bulk), and once the
//   audio is in (so that it does not queue behind them) its share of the
//   gravity row and of every history slot but the row's own
//   (cp.async.bulk.tensor over a 3-D tensor map of the (2, m) planes, one
//   copy a slot bringing its k runs of both planes), so the epilogue
//   reads shared memory only. The runs are m2/k >= 32 floats at offsets
//   that are multiples of m2/k floats, so every row of every box is a
//   multiple of 16 bytes at a 16-byte boundary (the copies' rule); the
//   wrapper checks that grav and hist start 16-byte aligned (pcm and
//   window 8-byte, for the float2 loads below). One tensor copy a slot,
//   where plain bulk copies would take 2k (one a run), keeps the issuing
//   thread short. Where F slots do not fit in shared memory (n 16384
//   with F above 17, n 32768 and 65536 with F above 3) the ring
//   streams through G slots in groups, one barrier phase a group. The audio is read straight from device
//   memory, each CTA its decimated x[j1 + k*j2], as 8-byte loads.
// * Few barriers. The m2-point FFT is a Stockham pass sequence of radix
//   8 (and 4) butterflies in registers, twiddles from the table copied
//   into shared memory: 3-4 CTA barriers where radix 2 took log2(m),
//   and no strided global twiddle loads. The cluster waits twice: that
//   every CTA has started (arrived at the kernel's start, waited for
//   before the first remote store) and that every bin has arrived.
//
// Why float64: a float32 FFT's rounding error is absolute, about
// eps * log2(m) * rms|X|, and the boost (up to ~20 for fft_scale 20)
// multiplies it into the spectrum; two correct float32 FFTs then
// differ by more than the 2e-5 spectrum tolerance from n = 4096 up.
// In float64 both this kernel and the plain version (complex128 FFT)
// produce the correctly rounded float32 spectrum, so they agree to an
// ulp at every n.
//
// Shared memory of one CTA, in this order: two mbarriers, padded to 128
// bytes (the tensor copies' alignment); the FFT's ping-pong buffers, the
// receive buffer of the k-point stage and the two twiddle tables, m2
// complex doubles each; the gravity share, 2*m2 floats; G history
// shares of 2*m2 floats; the F age weights. The plan owns its size:
// ops/fused.py FFTPlan.smem_bytes computes it and picks G, and the
// wrapper passes both (35 KB at n 4096, F 6; 218 KB at n 16384, F 16;
// 224 KB at n 32768 and 65536, F 6, three slots resident).

#include <cooperative_groups.h>
#include <cuda.h>           // CUtensorMap (types only; no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 16;      // epilogue elements a thread: 2*m2 <= 4096
constexpr int kMaxCluster = 16;  // 8 portable, 16 with the opt-in

struct Args {
    const float* pcm;
    const float* window;
    const double2* twiddle;   // W_m2^t (t < m2), then W_m^(j1*f2) (k x m2)
    const float* age_w;
    const int* slot;
    const float* fft_scale;
    const float* fft_cutoff;
    const float* gravity_g;
    float* grav;
    float* hist;
    float* avg;
    int n, F, k, m2, nstages, radix_code, G;
};

// -- mbarrier and bulk-copy primitives (PTX, sm_90) ---------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_u32(bar)) : "memory");
}

// the one arrival of a phase, announcing the bytes its copies bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// global -> this CTA's shared memory; dst, src, bytes multiples of 16
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src)),
           "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// the box of a 3-D tensor map at (x, y, z) -> shared memory (128-byte
// aligned), packed innermost first
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int x, int y, int z,
                                            uint64_t* bar)
{
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];"
        :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(x), "r"(y), "r"(z),
           "r"(smem_u32(bar)) : "memory");
}

// -- complex double arithmetic -----------------------------------------

__device__ __forceinline__ double2 cmul(double2 a, double2 b)
{
    return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b)
{
    return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b)
{
    return make_double2(a.x - b.x, a.y - b.y);
}
// -i * a
__device__ __forceinline__ double2 mul_mi(double2 a)
{
    return make_double2(a.y, -a.x);
}

// in-place R-point DFT, natural order: v[s] = sum_r v[r] W_R^(r*s)
template <int R> __device__ __forceinline__ void dft(double2* v);

template <> __device__ __forceinline__ void dft<2>(double2* v)
{
    const double2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
}

template <> __device__ __forceinline__ void dft<4>(double2* v)
{
    const double2 a = cadd(v[0], v[2]), b = csub(v[0], v[2]);
    const double2 c = cadd(v[1], v[3]), d = mul_mi(csub(v[1], v[3]));
    v[0] = cadd(a, c);
    v[2] = csub(a, c);
    v[1] = cadd(b, d);
    v[3] = csub(b, d);
}

template <> __device__ __forceinline__ void dft<8>(double2* v)
{
    constexpr double h = 0.70710678118654752440;   // sqrt(1/2)
    double2 e[4] = {v[0], v[2], v[4], v[6]};
    double2 o[4] = {v[1], v[3], v[5], v[7]};
    dft<4>(e);
    dft<4>(o);
    // W_8^s o[s], s < 4
    o[1] = make_double2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));
    o[2] = mul_mi(o[2]);
    o[3] = make_double2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        v[s] = cadd(e[s], o[s]);
        v[s + 4] = csub(e[s], o[s]);
    }
}

template <> __device__ __forceinline__ void dft<16>(double2* v)
{
    // W_16^s = cos(pi s/8) - i sin(pi s/8), s < 8
    constexpr double c1 = 0.92387953251128675613;   // cos(pi/8)
    constexpr double s1 = 0.38268343236508977173;   // sin(pi/8)
    constexpr double h = 0.70710678118654752440;    // sqrt(1/2)
    const double2 w[8] = {{1.0, 0.0}, {c1, -s1}, {h, -h}, {s1, -c1},
                          {0.0, -1.0}, {-s1, -c1}, {-h, -h}, {-c1, -s1}};
    double2 e[8], o[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        e[s] = v[2 * s];
        o[s] = v[2 * s + 1];
    }
    dft<8>(e);
    dft<8>(o);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        const double2 t = cmul(o[s], w[s]);
        v[s] = cadd(e[s], t);
        v[s + 8] = csub(e[s], t);
    }
}

// One Stockham pass of radix R over m2 points, Ns = product of the
// earlier passes' radices: butterfly j reads in[j + r*m2/R], scales by
// W_m2^(jm*r*m2/(Ns*R)) (jm = j mod Ns), and writes bin (j - jm)*R +
// jm + r*Ns. The last pass scales bin f2 by post[f2] = W_m^(rank*f2)
// and stores it into recv[rank*run + u] of the CTA that owns it,
// f2 = owner*run + u.
template <int R, bool kLast>
__device__ __forceinline__ void stockham_pass(const double2* in, double2* out,
                                              const double2* tw, int m2,
                                              int Ns, const double2* post,
                                              double2* recv, int lrun,
                                              int rank)
{
    const int Q = m2 / R;
    const int step = m2 / (Ns * R);
    for (int j = threadIdx.x; j < Q; j += kThreads) {
        double2 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = in[j + r * Q];
        const int jm = j & (Ns - 1);
#pragma unroll
        for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[jm * r * step]);
        dft<R>(v);
        const int d = (j - jm) * R + jm;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int at = d + r * Ns;
            if (kLast) {
                double2* dst =
                    cg::this_cluster().map_shared_rank(recv, at >> lrun);
                dst[(rank << lrun) + (at & ((1 << lrun) - 1))] =
                    cmul(v[r], post[at]);
            } else {
                out[at] = v[r];
            }
        }
    }
}

// lr = log2 of the pass's radix: 3 or 2 (the plan takes no other)
template <bool kLast>
__device__ __forceinline__ void fft_pass(int lr, const double2* in,
                                         double2* out, const double2* tw,
                                         int m2, int Ns, const double2* post,
                                         double2* recv, int lrun, int rank)
{
    if (lr == 3)
        stockham_pass<8, kLast>(in, out, tw, m2, Ns, post, recv, lrun, rank);
    else
        stockham_pass<4, kLast>(in, out, tw, m2, Ns, post, recv, lrun, rank);
}

__device__ __forceinline__ void cluster_arrive_relaxed()
{
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive()   // release
{
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait()     // acquire
{
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Group `grp` of the history ring (slots grp*G .., not the row's own
// slot, whose old value nothing reads) and, for group 0, the gravity
// share into shared memory on `bar`: one tensor copy a slot, its box
// (2 planes, k runs of m2/k floats at f1*m2 + rank*m2/k) landing as the
// epilogue's layout [c][f1][u].
__device__ void issue_history(const Args& a, const CUtensorMap* grav_map,
                              const CUtensorMap* hist_map, int row, int rank,
                              int sl, int grp, float* gs, float* hs,
                              uint64_t* bar)
{
    const int m2 = a.m2, x = rank * (m2 / a.k);
    const int f0 = grp * a.G;
    const int f1 = min(a.F, f0 + a.G);
    int boxes = grp == 0;
    for (int f = f0; f < f1; ++f) boxes += f != sl;
    mbar_expect(bar, (uint32_t)boxes * 2 * m2 * sizeof(float));
    if (grp == 0) tensor_copy(gs, grav_map, x, 0, 2 * row, bar);
    for (int f = f0; f < f1; ++f)
        if (f != sl)
            tensor_copy(hs + (size_t)(f - f0) * 2 * m2, hist_map, x, 0,
                        2 * (row * a.F + f), bar);
}

// kPer = 2*m2/kThreads epilogue elements a thread (1 to kMaxPer); kK
// the cluster sizes the instance takes: up to 8, or exactly 16 (only
// n 65536), so that the 16-point stage's registers do not cost the
// smaller clusters occupancy
template <int kPer, int kK>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const Args a, const __grid_constant__ CUtensorMap grav_map,
                    const __grid_constant__ CUtensorMap hist_map)
{
    extern __shared__ __align__(128) unsigned char smem[];
    cluster_arrive_relaxed();   // this CTA has started
    const int k = a.k, m2 = a.m2, n = a.n, F = a.F;
    const int rank = (int)cg::this_cluster().block_rank();
    const int row = blockIdx.x / k;
    const int run = m2 / k;         // bins of each of this CTA's k runs
    const int lrun = __ffs(run) - 1;
    const size_t m = (size_t)k * m2;
    const size_t plane = 2 * m;

    uint64_t* bars = (uint64_t*)smem;   // [0] tables; [1] history
    double2* buf0 = (double2*)(smem + 128);
    double2* buf1 = buf0 + m2;
    double2* recv = buf1 + m2;          // Y_j1 of the bins this CTA owns
    double2* tw = recv + m2;            // W_m2^t
    double2* post = tw + m2;            // W_m^(rank*f2)
    float* gs = (float*)(post + m2);    // gravity share, 2 x k runs
    float* hs = gs + 2 * m2;            // G history shares, same layout
    float* ws = hs + (size_t)a.G * 2 * m2;   // the F age weights

    // the row's parameters, loaded now so the epilogue waits on none
    int sl = a.slot[row] % F;
    if (sl < 0) sl += F;
    const float fs = a.fft_scale[row];
    const float base = 1.0f - a.fft_cutoff[row];
    const float g = a.gravity_g[row];
    for (int f = threadIdx.x; f < F; f += kThreads) ws[f] = a.age_w[f];

    if (threadIdx.x == 0) {
        mbar_init(&bars[0]);
        mbar_init(&bars[1]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();   // the barriers are initialised
    if (threadIdx.x == 0) {
        const uint32_t table = (uint32_t)m2 * sizeof(double2);
        mbar_expect(&bars[0], 2 * table);
        bulk_copy(tw, a.twiddle, table, &bars[0]);
        bulk_copy(post, a.twiddle + m2 + (size_t)rank * m2, table, &bars[0]);
    }

    // 1. x[rank + k*j2] = pcm * window, straight from the audio row
    const float2* pcm2 = (const float2*)(a.pcm + (size_t)row * n);
    const float2* win2 = (const float2*)a.window;
    for (int j2 = threadIdx.x; j2 < m2; j2 += kThreads) {
        const int g = rank + k * j2;
        const float2 x = __ldg(pcm2 + g), w = __ldg(win2 + g);
        buf0[j2] = make_double2(x.x * w.x, x.y * w.y);
    }
    __syncthreads();
    // the history once the audio is in, so the audio does not queue
    // behind it in device memory; it lands while the FFT runs
    if (threadIdx.x == 0)
        issue_history(a, &grav_map, &hist_map, row, rank, sl, 0, gs, hs,
                      &bars[1]);
    mbar_wait(&bars[0], 0);

    // 2. the m2-point FFT; the last pass, scaled by W_m^(rank*f2), goes
    //    to the owners' receive buffers once every CTA has started
    double2* in = buf0;
    double2* out = buf1;
    int Ns = 1;
    for (int s = 0; s < a.nstages - 1; ++s) {
        const int lr = (a.radix_code >> (2 * s)) & 3;
        fft_pass<false>(lr, in, out, tw, m2, Ns, post, recv, lrun, rank);
        __syncthreads();
        double2* t = in;
        in = out;
        out = t;
        Ns <<= lr;
    }
    cluster_wait();
    fft_pass<true>((a.radix_code >> (2 * (a.nstages - 1))) & 3, in, out, tw,
                   m2, Ns, post, recv, lrun, rank);
    cluster_arrive();
    cluster_wait();   // every CTA's bins are in

    // 3. bins f1*m2 + rank*run + u: k-point DFTs over j1, into buf0 at
    //    f1*run + u (the local order of the epilogue)
    for (int u = threadIdx.x; u < run; u += kThreads) {
        double2 v[kK];
#pragma unroll
        for (int j1 = 0; j1 < kK; ++j1)
            if (j1 < k) v[j1] = recv[j1 * run + u];
        if constexpr (kK == 16) {
            dft<16>(v);
        } else {
            switch (k) {
            case 8: dft<8>(v); break;
            case 4: dft<4>(v); break;
            case 2: dft<2>(v); break;
            default: break;
            }
        }
#pragma unroll
        for (int f1 = 0; f1 < kK; ++f1)
            if (f1 < k) buf0[f1 * run + u] = v[f1];
    }
    __syncthreads();

    // 4. epilogue on shared memory: spectrum, gravity, history, average.
    //    Element i of 2*m2: plane c = i / m2, local bin l = i % m2, global
    //    bin (l / run)*m2 + rank*run + l % run.
    float gv[kPer], acc[kPer];
    int at[kPer];
    mbar_wait(&bars[1], 0);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
        const int i = threadIdx.x + p * kThreads;
        if (i >= 2 * m2) continue;
        const int c = i >= m2, l = i - c * m2;
        const int bin = ((l >> lrun) * m2) + rank * run + (l & (run - 1));
        const double2 X = buf0[l];
        const float v = (float)(c ? X.y : X.x);
        // n is a power of two: times 1/n is exactly the division by n
        const float jn = (float)(2 * bin + c) * (1.0f / (float)n);
        float spec = logf(fabsf(v) + 1.0f) / 3.0f;
        spec = spec * fmaxf(jn * fs + base, 1.0f);
        spec = fminf(fmaxf(spec, 0.0f), 1.0f);
        float gval = fmaxf(gs[i], spec) - g;
        gval = fminf(fmaxf(gval, 0.0f), 1.0f);
        at[p] = c * (int)m + bin;
        a.grav[row * plane + at[p]] = gval;
        a.hist[((size_t)row * F + sl) * plane + at[p]] = gval;
        gv[p] = gval;
        acc[p] = 0.0f;
    }
    for (int grp = 0, f0 = 0; f0 < F; ++grp, f0 += a.G) {
        if (grp > 0) mbar_wait(&bars[1], grp & 1);
        const int f1 = min(F, f0 + a.G);
        for (int f = f0; f < f1; ++f) {
            int age = sl - f;
            if (age < 0) age += F;
            const float w = ws[age];
            const float* h = hs + (size_t)(f - f0) * 2 * m2;
#pragma unroll
            for (int p = 0; p < kPer; ++p) {
                const int i = threadIdx.x + p * kThreads;
                if (i < 2 * m2) acc[p] += w * (f == sl ? gv[p] : h[i]);
            }
        }
        if (f1 < F) {   // the streamed route: refill the slots
            __syncthreads();
            if (threadIdx.x == 0) {
                asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                issue_history(a, &grav_map, &hist_map, row, rank, sl, grp + 1,
                              gs, hs, &bars[1]);
            }
        }
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
        const int i = threadIdx.x + p * kThreads;
        if (i < 2 * m2)
            a.avg[row * plane + at[p]] = fminf(fmaxf(acc[p], 0.0f), 1.0f);
    }
}

// -- the split route (n above 65536) -----------------------------------
//
// A row of m = k * 2048 points does not fit one cluster (16 CTAs of
// 2048-point FFTs at most), so the four-step split goes through device
// memory in two launches, with no cluster:
//
// * Pass A, the columns. CTA (row, blk) takes `cols` columns j1 =
//   blk*cols .. of its row (1, or SPLIT_COLS at many rows), and lets
//   pass B launch at once. One thread asks for the m2-point twiddles by
//   bulk copy (cp.async.bulk on an mbarrier) and, with several columns,
//   for each column's W_m^(j1*f2) row while the column before it runs
//   its FFT. Its threads stage x[j1 + k*j2] * window for all of its
//   columns, the loads of several j2 issued before their stores (a
//   thread's `cols` loads of a j2 fall in one 32-byte sector, so the
//   stride-k read of the audio costs one sector a j2, not `cols`),
//   then, a column at a time, run the 2048-point Stockham FFT in
//   float64 (the one-cluster kernel's passes), scale bin f2 by
//   W_m^(j1*f2) and write Y[row, j1, f2] (double2) to the scratch
//   tensor the wrapper allocates.
// * Pass B, the k-point stage and the epilogue. CTA (row, blk) owns
//   `run` consecutive f2 = blk*run + col. It is launched as pass A's
//   programmatic dependent (cudaLaunchAttributeProgrammaticStreamSerial-
//   ization), and pass A lets it start at once, so pass B's CTAs start
//   while pass A runs: before waiting for pass A (griddepcontrol.wait)
//   a CTA asks for everything pass A never writes, into shared memory:
//   the k-point twiddles (bulk copy), its share of the gravity row and
//   of every history slot but the row's own (2 planes x k runs of `run`
//   floats each). Runs of 4 floats and more come by tensor copy
//   (cp.async.bulk.tensor over the (m2, k, planes) view, boxes of (run,
//   min(k, 256), 1)); runs of 2 and 1 float (k 2048, 4096), below the
//   copies' 16 bytes, by cp.async of 4 bytes, every thread its share.
//   Then it reads Y[row, :, f2] (runs of `run` complex doubles), takes
//   the k-point DFTs over j1 of all its columns at once as batched
//   Stockham passes (radix 8 and 4), and runs the epilogue on bins
//   f1*2048 + f2 against shared memory: gravity and the row's ring slot
//   written, the average summed in f order over the slots in shared
//   memory. Where F slots do not fit beside the stage's buffers, the
//   ring streams through G slots in groups, as in the one-cluster
//   kernel, the running sums parked in the stage's dead buffer.
//
// What bounds it: bytes at many rows, latency at a few. The scratch
// round trip (16 bytes a complex bin, written once and read once)
// doubles the ~40 bytes a bin the function itself must move at F 6. At
// a few rows the time is a chain: pass A's FFT, then pass B's read of
// Y, its stage passes and its epilogue; the history's reads, which
// made the epilogue a chain of device-memory round trips, now land
// while pass A runs. Offsets are size_t: B*F*n passes 2^31 (B 128,
// F 6, n 2^22).

constexpr int kMaxSplitCols = 4;   // ops/fused.py SPLIT_COLS
constexpr int kSplitPoints = 2048; // a column's FFT (ops/fused.py MAX_CTA_POINTS)
constexpr int kMaxBox = 256;       // a tensor copy's box: at most 256 a dimension

// griddepcontrol (sm_90): let the dependent grid launch; wait until the
// grids this one depends on have completed and their writes are visible
__device__ __forceinline__ void launch_dependents()
{
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait()
{
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

// 4 bytes global -> shared, completing at cp.async.wait_all
__device__ __forceinline__ void copy4(float* dst, const float* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src))
                 : "memory");
}

// kCols columns a CTA (1 or SPLIT_COLS; k is a multiple of both, so
// every CTA takes all kCols). With more than one column the W_m^(j1*f2)
// row of each comes into shared memory by bulk copy while the column
// before it runs its FFT; with one, where the CTA's 112 KB leave room
// for a second CTA an SM, it is read from device memory at the stores
template <int kCols>
__global__ void __launch_bounds__(kThreads)
split_columns_kernel(const float* __restrict__ pcm,
                     const float* __restrict__ window,
                     const double2* __restrict__ twiddle,
                     double2* __restrict__ Y, int n, int k, int nstages,
                     int radix_code)
{
    constexpr int m2 = kSplitPoints;
    constexpr int kPost = kCols > 1 ? m2 : 0;   // shared post row
    extern __shared__ __align__(128) unsigned char smem[];
    // pass B may start now: it reads only what this pass never writes
    // until its griddepcontrol.wait, which waits for this whole grid
    launch_dependents();
    uint64_t* bars = (uint64_t*)smem;        // [0] W_m2; [1] the post row
    double2* buf0 = (double2*)(smem + 128);
    double2* buf1 = buf0 + m2;
    double2* tw = buf1 + m2;                 // W_m2^t
    double2* post = tw + m2;                 // W_m^(j1*f2), the column at work
    float2* stage = (float2*)(post + kPost); // kCols x m2 windowed pairs
    const int blocks = k / kCols;
    const int row = blockIdx.x / blocks;
    const int j0 = (blockIdx.x % blocks) * kCols;
    constexpr uint32_t table = (uint32_t)m2 * sizeof(double2);

    if (threadIdx.x == 0) {
        mbar_init(&bars[0]);
        mbar_init(&bars[1]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        mbar_expect(&bars[0], table);
        bulk_copy(tw, twiddle, table, &bars[0]);
        if (kCols > 1) {
            mbar_expect(&bars[1], table);
            bulk_copy(post, twiddle + m2 + (size_t)j0 * m2, table, &bars[1]);
        }
    }
    // x[j1 + k*j2] * window for the kCols columns j1 of each j2 =
    // threadIdx.x + r*kThreads: a batch of j2's loads issued before its
    // stores, so the loads' round trips overlap
    const float2* pcm2 = (const float2*)(pcm + (size_t)row * n);
    const float2* win2 = (const float2*)window;
    constexpr int kBatch = kCols == 1 ? 8 : 2;
#pragma unroll
    for (int r0 = 0; r0 < m2 / kThreads; r0 += kBatch) {
        float2 x[kBatch][kCols], w[kBatch][kCols];
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
            const size_t g = (size_t)j0
                             + (size_t)k * (threadIdx.x + (r0 + r) * kThreads);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                x[r][c] = __ldg(pcm2 + g + c);
                w[r][c] = __ldg(win2 + g + c);
            }
        }
#pragma unroll
        for (int r = 0; r < kBatch; ++r)
#pragma unroll
            for (int c = 0; c < kCols; ++c)
                stage[c * m2 + threadIdx.x + (r0 + r) * kThreads] =
                    make_float2(x[r][c].x * w[r][c].x, x[r][c].y * w[r][c].y);
    }
    for (int c = 0; c < kCols; ++c) {
        __syncthreads();   // the stage is in; the last column's bins read
        if (kCols > 1 && c > 0 && threadIdx.x == 0) {   // this column's post row
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            mbar_expect(&bars[1], table);
            bulk_copy(post, twiddle + m2 + (size_t)(j0 + c) * m2, table,
                      &bars[1]);
        }
        for (int j2 = threadIdx.x; j2 < m2; j2 += kThreads) {
            const float2 v = stage[c * m2 + j2];
            buf0[j2] = make_double2(v.x, v.y);
        }
        __syncthreads();
        if (c == 0) mbar_wait(&bars[0], 0);
        double2* in = buf0;
        double2* out = buf1;
        int Ns = 1;
        for (int s = 0; s < nstages; ++s) {
            const int lr = (radix_code >> (2 * s)) & 3;
            fft_pass<false>(lr, in, out, tw, m2, Ns, nullptr, nullptr, 0, 0);
            __syncthreads();
            double2* t = in;
            in = out;
            out = t;
            Ns <<= lr;
        }
        const int j1 = j0 + c;
        double2* y = Y + ((size_t)row * k + j1) * m2;
        if constexpr (kCols > 1) {
            mbar_wait(&bars[1], c & 1);
            for (int f2 = threadIdx.x; f2 < m2; f2 += kThreads)
                y[f2] = cmul(in[f2], post[f2]);
        } else {
            const double2* postg = twiddle + m2 + (size_t)j1 * m2;
            for (int f2 = threadIdx.x; f2 < m2; f2 += kThreads)
                y[f2] = cmul(in[f2], __ldg(postg + f2));
        }
    }   // the columns
}

// One Stockham pass of radix R of the k-point DFT over the 2^lrun
// columns of a stage CTA at once: element (j, col) at j*2^lrun + col
template <int R>
__device__ __forceinline__ void stage_pass(const double2* in, double2* out,
                                           const double2* tw, int k, int Ns,
                                           int lrun)
{
    const int Q = k / R;
    const int step = k / (Ns * R);
    const int total = Q << lrun;
    const int cmask = (1 << lrun) - 1;
    for (int q = threadIdx.x; q < total; q += kThreads) {
        const int j = q >> lrun, col = q & cmask;
        double2 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = in[((j + r * Q) << lrun) + col];
        const int jm = j & (Ns - 1);
#pragma unroll
        for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[jm * r * step]);
        dft<R>(v);
        const int d = (j - jm) * R + jm;
#pragma unroll
        for (int r = 0; r < R; ++r) out[((d + r * Ns) << lrun) + col] = v[r];
    }
}

struct SplitArgs {
    const double2* Y;         // (B, k, m2) scaled column bins
    const double2* twiddle;   // the plan's table; W_k^t at m2 + m
    const float* age_w;
    const int* slot;
    const float* fft_scale;
    const float* fft_cutoff;
    const float* gravity_g;
    float* grav;
    float* hist;
    float* avg;
    int n, F, k, m2, kstages, kradix_code, run, G;
};

// Group `grp` of the history ring (slots grp*G .., not the row's own
// slot, whose old value nothing reads) and, for group 0, the gravity
// share into shared memory: element i = c*P + f1*run + u of a share is
// plane c's bin f1*m2 + f20 + u, the epilogue's order. kTensor: one
// thread's tensor copies on `bar`, a box of (run, min(k, 256), 1) each
// (the plane, and a quarter of the k runs at k 1024); else every
// thread's 4-byte cp.async copies.
template <bool kTensor>
__device__ void issue_split_history(const SplitArgs& a,
                                    const CUtensorMap* grav_map,
                                    const CUtensorMap* hist_map, int row,
                                    int f20, int sl, int grp, float* gs,
                                    float* hs, uint64_t* bar)
{
    const int F = a.F, k = a.k, run = a.run, P = k * run;
    const int f0 = grp * a.G;
    const int f1 = min(F, f0 + a.G);
    if constexpr (kTensor) {
        if (threadIdx.x != 0) return;
        const int kbox = min(k, kMaxBox);
        int slots = grp == 0;
        for (int f = f0; f < f1; ++f) slots += f != sl;
        mbar_expect(bar, (uint32_t)slots * 2 * P * sizeof(float));
        for (int c = 0; c < 2; ++c)
            for (int y0 = 0; y0 < k; y0 += kbox) {
                const int at = c * P + y0 * run;
                if (grp == 0)
                    tensor_copy(gs + at, grav_map, f20, y0, 2 * row + c, bar);
                for (int f = f0; f < f1; ++f)
                    if (f != sl)
                        tensor_copy(hs + (size_t)(f - f0) * 2 * P + at, hist_map,
                                    f20, y0, 2 * (row * F + f) + c, bar);
            }
    } else {
        const size_t m = (size_t)k * a.m2, plane = 2 * m;
        const int lrun = __ffs(run) - 1;
        for (int i = threadIdx.x; i < 2 * P; i += kThreads) {
            const int c = i >= P, l = i - c * P;
            const size_t at = c * m + (size_t)(l >> lrun) * a.m2 + f20
                              + (l & (run - 1));
            if (grp == 0) copy4(gs + i, a.grav + row * plane + at);
            for (int f = f0; f < f1; ++f)
                if (f != sl)
                    copy4(hs + (size_t)(f - f0) * 2 * P + i,
                          a.hist + ((size_t)row * F + f) * plane + at);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
    }
}

// the history group issued last has landed, for every thread
template <bool kTensor>
__device__ __forceinline__ void wait_history(uint64_t* bars, int grp)
{
    if constexpr (kTensor) {
        mbar_wait(&bars[1], grp & 1);
    } else {
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();
    }
}

// kTensor: the history by tensor copy (runs of 4 floats and more), else
// by cp.async. kPoints = k * run (FFTPlan.split_points): 1024 to k 256,
// 2048 at k 512, the k-point twiddles copied into shared memory; 4096
// at k >= 1024, whose stage buffers leave no room for them: read from
// device memory through L1
template <bool kTensor, int kPoints>
__global__ void __launch_bounds__(kThreads)
split_stage_kernel(const SplitArgs a,
                   const __grid_constant__ CUtensorMap grav_map,
                   const __grid_constant__ CUtensorMap hist_map)
{
    constexpr bool kTwShared = kPoints <= kSplitPoints;
    constexpr int kPer = 2 * kPoints / kThreads;   // epilogue elements a thread
    constexpr int P = kPoints;
    extern __shared__ __align__(128) unsigned char smem[];
    const int k = a.k, m2 = a.m2, run = a.run, F = a.F;
    const int lrun = __ffs(run) - 1;
    const size_t m = (size_t)k * m2;
    const size_t plane = 2 * m;
    uint64_t* bars = (uint64_t*)smem;   // [0] twiddles; [1] history
    double2* buf0 = (double2*)(smem + 128);
    double2* buf1 = buf0 + P;
    double2* tws = buf1 + P;                            // W_k^t
    float* gs = (float*)(tws + (kTwShared ? k : 0));    // gravity share
    float* hs = gs + 2 * P;                             // G history shares
    float* ws = hs + (size_t)a.G * 2 * P;               // the F age weights
    const int blocks = m2 / run;
    const int row = blockIdx.x / blocks;
    const int f20 = (blockIdx.x % blocks) * run;

    // the row's parameters and the prefetch, none of it written by pass A
    int sl = a.slot[row] % F;
    if (sl < 0) sl += F;
    const float fs = a.fft_scale[row];
    const float base = 1.0f - a.fft_cutoff[row];
    const float g = a.gravity_g[row];
    for (int f = threadIdx.x; f < F; f += kThreads) ws[f] = a.age_w[f];
    const double2* __restrict__ ktw = a.twiddle + m2 + m;
    if (threadIdx.x == 0) {
        mbar_init(&bars[0]);
        mbar_init(&bars[1]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        if constexpr (kTwShared) {
            const uint32_t bytes = (uint32_t)k * sizeof(double2);
            mbar_expect(&bars[0], bytes);
            bulk_copy(tws, ktw, bytes, &bars[0]);
        }
    }
    __syncthreads();   // the barriers are initialised
    issue_split_history<kTensor>(a, &grav_map, &hist_map, row, f20, sl, 0,
                                 gs, hs, &bars[1]);
    grid_dependency_wait();   // pass A's Y is complete and visible

    // Y[row, j1, f20 + col] -> buf0[j1*run + col], every thread 4 or 8
    // loads at once
    constexpr int kLoads = P / kThreads < 8 ? P / kThreads : 8;
    const double2* __restrict__ y = a.Y + (size_t)row * m + f20;
#pragma unroll
    for (int q0 = 0; q0 < P; q0 += kLoads * kThreads) {
        double2 v[kLoads];
#pragma unroll
        for (int r = 0; r < kLoads; ++r) {
            const int q = q0 + r * kThreads + threadIdx.x;
            v[r] = __ldcg(y + (size_t)(q >> lrun) * m2 + (q & (run - 1)));
        }
#pragma unroll
        for (int r = 0; r < kLoads; ++r)
            buf0[q0 + r * kThreads + threadIdx.x] = v[r];
    }
    __syncthreads();   // Y is in
    if constexpr (kTwShared) mbar_wait(&bars[0], 0);
    const double2* tw = kTwShared ? tws : ktw;

    double2* in = buf0;
    double2* out = buf1;
    int Ns = 1;
    for (int s = 0; s < a.kstages; ++s) {
        const int lr = (a.kradix_code >> (2 * s)) & 3;
        if (lr == 3)
            stage_pass<8>(in, out, tw, k, Ns, lrun);
        else
            stage_pass<4>(in, out, tw, k, Ns, lrun);
        __syncthreads();
        double2* t = in;
        in = out;
        out = t;
        Ns <<= lr;
    }

    // the epilogue of bins f1*m2 + f20 + col, held at in[f1*run + col]:
    // element i = threadIdx.x + p*kThreads of 2P, plane c = i / P, local
    // l = i % P, its gravity value and running sum in registers, the
    // ring summed in f order a group of resident slots at a time
    float* __restrict__ grav = a.grav + (size_t)row * plane;
    float* __restrict__ own = a.hist + ((size_t)row * F + sl) * plane;
    float* __restrict__ avg = a.avg + (size_t)row * plane;
    float gv[kPer], acc[kPer];
    wait_history<kTensor>(bars, 0);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
        const int i = threadIdx.x + p * kThreads;
        const int c = i >= kPoints, l = i - c * kPoints;
        // bins < 2^23: 2*bin + c converts to float exactly
        const int bin = (l >> lrun) * m2 + f20 + (l & (run - 1));
        const size_t at = (size_t)c * m + bin;
        const double2 X = in[l];
        const float v = (float)(c ? X.y : X.x);
        // n is a power of two: times 1/n is exactly the division by n
        const float jn = (float)(2 * bin + c) * (1.0f / (float)a.n);
        float spec = logf(fabsf(v) + 1.0f) / 3.0f;
        spec = spec * fmaxf(jn * fs + base, 1.0f);
        spec = fminf(fmaxf(spec, 0.0f), 1.0f);
        float gval = fmaxf(gs[i], spec) - g;
        gval = fminf(fmaxf(gval, 0.0f), 1.0f);
        grav[at] = gval;
        own[at] = gval;
        gv[p] = gval;
        acc[p] = 0.0f;
    }
    for (int grp = 0, f0 = 0; f0 < F; ++grp, f0 += a.G) {
        if (grp > 0) wait_history<kTensor>(bars, grp);
        const int f1 = min(F, f0 + a.G);
        for (int f = f0; f < f1; ++f) {
            int age = sl - f;
            if (age < 0) age += F;
            const float w = ws[age];
            const float* h = hs + (size_t)(f - f0) * 2 * kPoints;
#pragma unroll
            for (int p = 0; p < kPer; ++p)
                acc[p] += w * (f == sl ? gv[p] : h[threadIdx.x + p * kThreads]);
        }
        if (f1 < F) {   // the streamed route: refill the slots
            __syncthreads();
            if (kTensor && threadIdx.x == 0)
                asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            issue_split_history<kTensor>(a, &grav_map, &hist_map, row, f20,
                                         sl, grp + 1, gs, hs, &bars[1]);
        }
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
        const int i = threadIdx.x + p * kThreads;
        const int c = i >= kPoints, l = i - c * kPoints;
        const size_t at = (size_t)c * m + (l >> lrun) * m2 + f20 + (l & (run - 1));
        avg[at] = fminf(fmaxf(acc[p], 0.0f), 1.0f);
    }   // the averages
}

// log2 radices in 2-bit fields -> the points they multiply to, or 0 if a
// pass is not radix 8 or 4
int stage_points(int nstages, int radix_code)
{
    int points = 1;
    for (int s = 0; s < nstages; ++s) {
        const int lr = (radix_code >> (2 * s)) & 3;
        if (lr < 2) return 0;
        points <<= lr;
    }
    return points;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// `planes` float vectors of m = k*m2 as a 3-D tensor (m2, k, planes),
// boxes of (run, kbox, zbox): the one-cluster route's (m2/k, k, 2), one
// slot's (or the gravity row's) two planes, the k runs of m2/k floats
// that one CTA owns; the split route's (run, min(k, 256), 1)
cudaError_t plane_map(CUtensorMap* map, void* base, unsigned long long planes,
                      int k, int m2, int run, int kbox, int zbox)
{
    static EncodeTiled encode = nullptr;
    if (!encode) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || !fn)
            return cudaErrorSymbolNotFound;
        encode = (EncodeTiled)fn;
    }
    const cuuint64_t dims[3] = {(cuuint64_t)m2, (cuuint64_t)k, planes};
    const cuuint64_t strides[2] = {(cuuint64_t)m2 * sizeof(float),
                                   (cuuint64_t)k * m2 * sizeof(float)};
    const cuuint32_t box[3] = {(cuuint32_t)run, (cuuint32_t)kbox,
                               (cuuint32_t)zbox};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box, unit,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success): a
// refused cluster or shared-memory request is returned, never retried
// with another plan. The caller validates shapes (n a power of two in
// [256, 65536], B >= 1, F >= 1, every pointer a contiguous device
// buffer of the layout above, grav and hist 16-byte aligned, pcm and
// window 8-byte) and passes the plan of
// ops/fused.py fft_plan(n): k CTAs a row, the m/k-point FFT's passes
// (nstages, log2 radices in 2-bit fields of radix_code), G resident
// history slots and the dynamic shared memory in bytes.
extern "C" int glava_fused_update(
    const void* pcm, const void* window, const void* twiddle,
    const void* age_w, const void* slot, const void* fft_scale,
    const void* fft_cutoff, const void* gravity_g,
    void* grav, void* hist, void* avg,
    int B, int n, int F, int k, int nstages, int radix_code, int G,
    int smem, void* stream)
{
    const int m = n >> 1;
    if (B < 1 || F < 1 || G < 1 || G > F || k < 1 || k > kMaxCluster
        || m % k)
        return (int)cudaErrorInvalidValue;
    const int m2 = m / k;
    // runs of m2/k >= 4 floats keep every copy's rows 16-byte multiples
    if (stage_points(nstages, radix_code) != m2 || 2 * m2 < kThreads || 2 * m2 > kMaxPer * kThreads
        || (k & (k - 1)) || m2 / k < 4)
        return (int)cudaErrorInvalidValue;
    // a cluster of 16 has one instance: 2048-point CTA FFTs (n 65536)
    if (k > 8 && 2 * m2 != kMaxPer * kThreads)
        return (int)cudaErrorInvalidValue;
    CUtensorMap grav_map, hist_map;
    cudaError_t err = plane_map(&grav_map, grav, 2ull * B, k, m2, m2 / k, k, 2);
    if (err == cudaSuccess)
        err = plane_map(&hist_map, hist, 2ull * B * F, k, m2, m2 / k, k, 2);
    if (err != cudaSuccess) return (int)err;

    void (*kernel)(const Args, const CUtensorMap, const CUtensorMap);
    switch (2 * m2 / kThreads) {
    case 1: kernel = fused_update_kernel<1, 8>; break;
    case 2: kernel = fused_update_kernel<2, 8>; break;
    case 4: kernel = fused_update_kernel<4, 8>; break;
    case 8: kernel = fused_update_kernel<8, 8>; break;
    default: kernel = fused_update_kernel<kMaxPer, 8>; break;
    }
    if (k == kMaxCluster) kernel = fused_update_kernel<kMaxPer, kMaxCluster>;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    if (k > 8) {   // above the portable cluster size
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
    }
    const Args a = {
        (const float*)pcm, (const float*)window, (const double2*)twiddle,
        (const float*)age_w, (const int*)slot, (const float*)fft_scale,
        (const float*)fft_cutoff, (const float*)gravity_g,
        (float*)grav, (float*)hist, (float*)avg,
        n, F, k, m2, nstages, radix_code, G};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)B * k);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a, grav_map, hist_map);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}


// The split route (n above 65536), two launches on `stream`; returns a
// CUDA error code (0 on success): a refused shared-memory request,
// tensor map or launch (pass B's programmatic dependent launch
// included) is returned, never retried another way. The caller
// validates as for glava_fused_update, allocates `scratch` (B x m
// complex doubles) on the rows' device, and passes the plan of
// ops/fused.py fft_plan(n) (its split_args): k column CTAs' worth of
// columns a row, the m/k = 2048-point column FFT's passes, the k-point
// stage's passes, the columns a column CTA takes, the f2 a stage CTA
// owns, the history slots it holds at once, whether its history comes
// by tensor copy, and the two CTAs' dynamic shared memory in bytes.
extern "C" int glava_fused_update_split(
    const void* pcm, const void* window, const void* twiddle,
    const void* age_w, const void* slot, const void* fft_scale,
    const void* fft_cutoff, const void* gravity_g,
    void* grav, void* hist, void* avg, void* scratch,
    int B, int n, int F, int k, int nstages, int radix_code, int kstages,
    int kradix_code, int cols, int run, int G, int tensor, int smem_a,
    int smem_b, void* stream)
{
    const int m = n >> 1;
    if (B < 1 || F < 1 || G < 1 || G > F || k < 16 || (k & (k - 1))
        || m != k * kSplitPoints || (cols != 1 && cols != kMaxSplitCols)
        || run < 1 || (run & (run - 1)) || (tensor && run < 4))
        return (int)cudaErrorInvalidValue;
    const int m2 = kSplitPoints;
    const long long P = (long long)k * run;
    if (stage_points(nstages, radix_code) != m2
        || stage_points(kstages, kradix_code) != k || m2 % run)
        return (int)cudaErrorInvalidValue;
    // a stage CTA's points (FFTPlan.split_points): 1024 to k 256, 4k to
    // k 1024, 4096 above; the cp.async copies only at 4096
    const long long want = k <= 256 ? 1024 : (k <= 1024 ? 4LL * k : 4096);
    if (P != want || (!tensor && P != 4096))
        return (int)cudaErrorInvalidValue;
    // the layouts the kernels carve (ops/fused.py FFTPlan.split_smem)
    const long long need_a = 128 + 48LL * m2 + (cols > 1 ? 16LL * m2 : 0)
                             + 8LL * cols * m2;
    const long long need_b = 128 + 32 * P + (P <= kSplitPoints ? 16LL * k : 0)
                             + 8 * P * (1 + G) + 4LL * F;
    if (smem_a < need_a || smem_b < need_b)
        return (int)cudaErrorInvalidValue;
    const long long grid_a = (long long)B * (k / cols);
    const long long grid_b = (long long)B * (m2 / run);
    if (grid_a > 0x7fffffff || grid_b > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    void (*stage)(const SplitArgs, const CUtensorMap, const CUtensorMap) =
        !tensor     ? split_stage_kernel<false, 4096>
        : P == 1024 ? split_stage_kernel<true, 1024>
        : P == 2048 ? split_stage_kernel<true, 2048>
                    : split_stage_kernel<true, 4096>;
    void (*columns)(const float*, const float*, const double2*, double2*,
                    int, int, int, int) =
        cols == 1 ? split_columns_kernel<1> : split_columns_kernel<kMaxSplitCols>;
    // the opt-in applies to the current device: asked at every launch
    cudaError_t err = cudaFuncSetAttribute(
        columns, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            stage, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
    CUtensorMap grav_map = {}, hist_map = {};
    const int kbox = k < kMaxBox ? k : kMaxBox;
    if (err == cudaSuccess && tensor)
        err = plane_map(&grav_map, grav, 2ull * B, k, m2, run, kbox, 1);
    if (err == cudaSuccess && tensor)
        err = plane_map(&hist_map, hist, 2ull * B * F, k, m2, run, kbox, 1);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t s = (cudaStream_t)stream;
    columns<<<(unsigned)grid_a, kThreads, smem_a, s>>>(
        (const float*)pcm, (const float*)window, (const double2*)twiddle,
        (double2*)scratch, n, k, nstages, radix_code);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const SplitArgs a = {
        (const double2*)scratch, (const double2*)twiddle, (const float*)age_w,
        (const int*)slot, (const float*)fft_scale, (const float*)fft_cutoff,
        (const float*)gravity_g, (float*)grav, (float*)hist, (float*)avg,
        n, F, k, m2, kstages, kradix_code, run, G};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid_b);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem_b;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, stage, a, grav_map, hist_map);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

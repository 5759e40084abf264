// Bars raster for NVIDIA Hopper (sm_90a): (S, 4, H, W) channel planes.
//
// Replaces the TPU kernel scripts/exp_pallas_bars.py:pallas_raster (its
// pl.pallas_call, one per channel), which computes the raster stage of
// the bars pass (glava_tpu/render/modules/bars.py pass1) line for line,
// and adds a leading stream axis so a fleet of S streams rasterizes in
// one launch. Per pixel (s, y, x) of stream s:
//
//   body = d[y] <  v[s, x] - bow        (f32 subtract, as torch does)
//   edge = d[y] <= v[s, x]
//   outlined:  body & inner[x]                 -> color[s, y]
//              (edge & !body) | (body & !inner) -> outline[s, y]
//              else 0
//   otherwise: body -> color[s, y], else 0
//
// Comparisons and selects only, so the result is bit-identical with the
// plain torch version (ops/raster.py bars_raster_plain). Gap and
// out-of-range columns carry v = -inf and never draw.
//
// Layouts: v (S, W) float32; inner (W,) bool as bytes; d (H,) float32;
// color and outline (S or 1, H, 4) float32, read through a stream
// stride (0 when every stream shares one table); out (S, 4, H, W)
// float32. All contiguous.
//
// What bounds it on the card: the writes. The inputs are a few KB a
// stream; the output is S * 4 * H * W floats (491.5 MB at S = 64 and
// 800x600, 2.12 GB at 1920x1080), ~147 us and ~634 us at 3.35 TB/s.
// The design keeps every write coalesced and every read out of the
// inner loop: one thread a column, threads consecutive along W, each
// walking kRows rows; v and inner are read once a thread, and the
// block's rows of d, color and outline are staged once in shared memory
// (all threads of a warp then read the same word, a broadcast). Each
// row then costs four 128-byte warp stores, one a channel plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // columns a block
constexpr int kRows = 16;       // rows a block

__global__ void __launch_bounds__(kThreads)
bars_raster_kernel(const float* __restrict__ v,
                   const uint8_t* __restrict__ inner,
                   const float* __restrict__ d,
                   const float* __restrict__ color,
                   const float* __restrict__ outline,
                   float* __restrict__ out,
                   int H, int W, long long color_stride,
                   long long outline_stride, float bow, int outlined)
{
    __shared__ float fill_c[kRows][4];
    __shared__ float rim_c[kRows][4];
    __shared__ float row_d[kRows];
    const int s = blockIdx.z;
    const int y0 = blockIdx.y * kRows;
    const int rows = min(kRows, H - y0);
    const float* crow = color + (size_t)s * color_stride + (size_t)y0 * 4;
    const float* orow = outline + (size_t)s * outline_stride + (size_t)y0 * 4;
    for (int i = threadIdx.x; i < rows * 4; i += blockDim.x) {
        fill_c[i >> 2][i & 3] = crow[i];
        rim_c[i >> 2][i & 3] = orow[i];
    }
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
        row_d[r] = d[y0 + r];
    __syncthreads();

    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= W) return;
    const float vx = v[(size_t)s * W + x];
    const float top = vx - bow;
    const bool in = inner[x] != 0;
    const size_t plane = (size_t)H * W;
    float* o = out + (size_t)s * 4 * plane + (size_t)y0 * W + x;
    for (int r = 0; r < rows; ++r, o += W) {
        const float dy = row_d[r];
        const bool body = dy < top;
        // 0: nothing, 1: fill colour, 2: outline colour
        int which;
        if (outlined)
            which = body ? (in ? 1 : 2) : (dy <= vx ? 2 : 0);
        else
            which = body ? 1 : 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
            o[c * plane] = which == 1 ? fill_c[r][c]
                         : which == 2 ? rim_c[r][c] : 0.0f;
    }
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The
// caller validates: 1 <= S <= 65535, H >= 1, W >= 1, every pointer a
// contiguous device buffer of the layout above, each colour stride 0
// or H * 4.
extern "C" int glava_bars_raster(const void* v, const void* inner,
                                 const void* d, const void* color,
                                 const void* outline, void* out, int S,
                                 int H, int W, long long color_stride,
                                 long long outline_stride, float bow,
                                 int outlined, void* stream)
{
    if (S < 1 || S > 65535 || H < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    const long long yblocks = ((long long)H + kRows - 1) / kRows;
    if (yblocks > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((W + kThreads - 1) / kThreads), (unsigned)yblocks,
              (unsigned)S);
    bars_raster_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)v, (const uint8_t*)inner, (const float*)d,
        (const float*)color, (const float*)outline, (float*)out, H, W,
        color_stride, outline_stride, bow, outlined);
    return (int)cudaGetLastError();
}

// The while node of a captured shader step, for NVIDIA Hopper (sm_90a):
// a CUDA conditional WHILE graph node and the kernel that decides it.
//
// Replaces no Pallas kernel. It is the counterpart of the lax.while_loop
// that the JAX interpreter lowers a data-dependent GLSL loop to
// (glava_tpu/config/glsl_shader.py:2095-2147): inside one compiled step
// the loop runs on the device until no pixel is active or the fuel cap
// is reached, and no frame reads the host. PyTorch exposes only if
// nodes (CUDAGraph::begin_capture_to_if_node), so the node is built here
// the same way, with the WHILE type:
//
//   glava_while_handle   a conditional handle in the graph the parent
//                        stream captures into;
//   glava_while_set      launched once on the parent stream before the
//                        node and once at the end of the body: sets the
//                        handle to (any byte of the active plane) and
//                        (*fuel < cap), and writes that value to go;
//   glava_while_open     adds the WHILE node after the parent stream's
//                        current dependencies, makes it the stream's one
//                        dependency, and begins capturing the child
//                        stream into the node's body graph;
//   glava_while_close    ends the child stream's capture.
//
// Nested loops are nested nodes: a loop met inside a body captures its
// handle and node into the body graph its own parent (the outer child
// stream) captures into. Without the handle flag the setter only writes
// go (the eager step reads it back each iteration).
//
// What bounds the setter on this card: bytes. It reads the active plane
// once, H * W bytes (2.07 MB at 1920x1080: 0.62 us at 3.35 TB/s) and a
// few words; the work around the reads (a launch, the grid's OR, the
// last CTA's decision) is of the same size, so the design keeps it
// short:
//
//   * one wave, about one CTA an SM: each CTA reads one contiguous share
//     of the plane, kUnroll 16-byte loads a thread issued before any is
//     used, so a CTA's whole share (16 KB) is in flight at once;
//   * the CTA's OR: one barrier that votes (bar.red.or);
//   * the grid's OR: CTAs form clusters of kCluster; each writes its
//     vote into rank 0's shared memory (distributed shared memory), and
//     after one cluster barrier rank 0 alone adds to the ticket word
//     sync[1]: one atomic a cluster, no fence (the word itself carries
//     both the clusters done, low half, and the clusters that saw a
//     pixel, high half). The last cluster's rank 0 decides, sets the
//     handle and zeroes the word for the next launch.
//
// The plane must be 16-byte aligned (the wrapper allocates it).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                   // 16-byte loads a thread in flight
constexpr int kChunk = kThreads * kUnroll;   // 16-byte words a CTA reads a round
constexpr int kCluster = 4;                  // CTAs a cluster
constexpr unsigned int kSawPixel = 1u << 16; // the ticket word's high half

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
while_set_kernel(cudaGraphConditionalHandle handle, int set_handle,
                 const uint4* __restrict__ act16, long long n16,
                 long long share, const unsigned char* __restrict__ tail,
                 int ntail, const int* __restrict__ fuel, int cap,
                 unsigned int* __restrict__ sync, int* __restrict__ go_out) {
  // the fuel, read now by the thread that may decide, off the chain of
  // round trips at the end
  const int fuel_now = threadIdx.x == 0 ? *fuel : 0;
  const long long begin = (long long)blockIdx.x * share;
  const long long end = begin + share < n16 ? begin + share : n16;
  unsigned int any = 0u;
  for (long long base = begin + threadIdx.x; base < end; base += kChunk) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      v[u] = i < end ? __ldg(act16 + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) any |= v[u].x | v[u].y | v[u].z | v[u].w;
  }
  if (blockIdx.x == 0 && threadIdx.x < ntail) any |= tail[threadIdx.x];
  const int block_any = __syncthreads_or(any != 0u);

  __shared__ unsigned int votes[kCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();
  if (threadIdx.x == 0)
    *cluster.map_shared_rank(&votes[rank], 0) = (unsigned int)block_any;
  cluster.sync();
  if (rank != 0 || threadIdx.x != 0) return;
  unsigned int saw = 0u;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) saw |= votes[r];
  const unsigned int old = atomicAdd(&sync[1], 1u + (saw ? kSawPixel : 0u));
  if ((old & (kSawPixel - 1u)) + 1u != gridDim.x / kCluster) return;
  sync[1] = 0u;
  const bool seen = saw != 0u || (old >> 16) != 0u;
  const unsigned int go = (seen && fuel_now < cap) ? 1u : 0u;
  *go_out = (int)go;
  if (set_handle) cudaGraphSetConditional(handle, go);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                             nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                             ndeps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureUnmatched;
}

}  // namespace

extern "C" {

// The setter on `stream`: go[0] (int32) = any(active[0:n]) && fuel[0] <
// cap, and the handle set to it when set_handle is nonzero. sync: two
// zeroed uint32 words the launches share (left zeroed).
int glava_while_set(unsigned long long handle, int set_handle, const void* active,
                    long long n, const void* fuel, int cap, void* sync,
                    void* go, void* stream) {
  if (((uintptr_t)active & 15u) != 0 || n < 0) return (int)cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n16 = n / 16;
  const int ntail = (int)(n - n16 * 16);
  // one round of kChunk words a CTA, at most one wave of one CTA an SM
  long long clusters = ((n16 + kChunk - 1) / kChunk + kCluster - 1) / kCluster;
  const long long wave = sms / kCluster > 0 ? sms / kCluster : 1;
  if (clusters < 1) clusters = 1;
  if (clusters > wave) clusters = wave;
  const long long grid = clusters * kCluster;
  const long long share = (n16 + grid - 1) / grid;
  while_set_kernel<<<(unsigned int)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (cudaGraphConditionalHandle)handle, set_handle, (const uint4*)active,
      n16, share, (const unsigned char*)active + n16 * 16, ntail,
      (const int*)fuel, cap, (unsigned int*)sync, (int*)go);
  return (int)cudaGetLastError();
}

// A conditional handle (default value 0, reset at every launch of the
// graph) in the graph `stream` captures into.
int glava_while_handle(void* stream, unsigned long long* handle_out) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info((cudaStream_t)stream, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0,
                                         cudaGraphCondAssignDefault);
  *handle_out = (unsigned long long)h;
  return (int)err;
}

// The WHILE node on `handle` after `stream`'s dependencies; `child`
// begins capturing into its body (capture mode `mode`, as the parent's).
int glava_while_open(void* stream, void* child, unsigned long long handle,
                     int mode) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info((cudaStream_t)stream, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies((cudaStream_t)stream, &node,
                                            nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies((cudaStream_t)stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)child, body, nullptr, nullptr, 0,
      (cudaStreamCaptureMode)mode);
}

// Ends `child`'s capture into a body graph (the node owns the graph).
int glava_while_close(void* child) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)child, &body);
}

// A stream of its own for a body's capture (non-blocking, as PyTorch's
// if node makes one): a pooled PyTorch stream could be one that is
// already capturing.
int glava_while_stream(void** stream_out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream_out = (void*)s;
  return (int)err;
}

}  // extern "C"

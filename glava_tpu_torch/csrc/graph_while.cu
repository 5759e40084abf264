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
// stream) captures into. With set_handle 0 the setter only writes go
// (the eager step reads it back each iteration).
//
// What bounds the setter on this card: bytes. It reads the active plane
// once, H * W bytes (2.07 MB at 1920x1080: 0.62 us at 3.35 TB/s) and a
// few words. Design: a grid-stride OR over 16-byte loads, one barrier
// OR a CTA, one atomic OR a CTA into sync[0], and the last CTA to
// finish (sync[1], a ticket) reads the OR, sets the handle and resets
// both words for the next launch. The plane must be 16-byte aligned
// (the wrapper allocates it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;   // 2 CTAs an SM on 132 SMs

__global__ void __launch_bounds__(kThreads)
while_set_kernel(cudaGraphConditionalHandle handle, int set_handle,
                 const uint4* __restrict__ act16, long long n16,
                 const unsigned char* __restrict__ tail, int ntail,
                 const int* __restrict__ fuel, int cap,
                 unsigned int* __restrict__ sync, int* __restrict__ go_out) {
  unsigned int any = 0u;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n16;
       i += stride) {
    const uint4 v = act16[i];
    any |= v.x | v.y | v.z | v.w;
  }
  if (blockIdx.x == 0 && threadIdx.x < ntail) any |= tail[threadIdx.x];
  const int block_any = __syncthreads_or(any != 0u);
  if (threadIdx.x != 0) return;
  if (block_any) atomicOr(&sync[0], 1u);
  __threadfence();
  const unsigned int ticket = atomicAdd(&sync[1], 1u);
  if (ticket != gridDim.x - 1) return;
  __threadfence();
  const unsigned int seen = atomicExch(&sync[0], 0u);
  sync[1] = 0u;
  const unsigned int go = (seen != 0u && *fuel < cap) ? 1u : 0u;
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
// cap, and the handle set to it when set_handle. sync: two zeroed
// uint32 words the launches share (left zeroed).
int glava_while_set(unsigned long long handle, int set_handle,
                    const void* active, long long n, const void* fuel,
                    int cap, void* sync, void* go, void* stream) {
  if (((uintptr_t)active & 15u) != 0 || n < 0) return (int)cudaErrorInvalidValue;
  const long long n16 = n / 16;
  const int ntail = (int)(n - n16 * 16);
  long long blocks = (n16 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  while_set_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (cudaGraphConditionalHandle)handle, set_handle,
      (const uint4*)active, n16,
      (const unsigned char*)active + n16 * 16, ntail,
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

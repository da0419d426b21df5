// Stage marks of a compiled step (common/stages.py): a one-thread kernel
// that stamps the card's global nanosecond timer into a ring of replays,
// captured into the step's CUDA graph between its stages, and a count of
// the kernel nodes a capture holds so far, taken on the host at each mark.
// It replaces no TPU kernel: the JAX package's steps are timed by the
// profiler only. Bound by its launch (one thread, one 8-byte store).
#include <cuda_runtime.h>

#include <vector>

namespace {

// ring: `rows` replays of `slots` int64 stamps, then one int64 counter,
// the replay being written; the mark with `close` set advances it.
__global__ void stage_mark_kernel(long long* ring, int rows, int slots, int slot, int close) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* counter = ring + static_cast<long long>(rows) * slots;
  const long long k = *counter;
  ring[(k % rows) * slots + slot] = static_cast<long long>(now);
  if (close) *counter = k + 1;
}

cudaError_t count_kernels(cudaGraph_t graph, long long* out) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) break;
    if (type == cudaGraphNodeTypeKernel) {
      ++*out;
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = count_kernels(child, out);
    }
  }
  return err;
}

}  // namespace

extern "C" int dliom_stage_mark(void* ring, int rows, int slots, int slot, int close, void* stream) {
  stage_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(ring), rows,
                                                                     slots, slot, close);
  return static_cast<int>(cudaGetLastError());
}

// The kernel nodes (child graphs' included) of the graph that `stream` is
// capturing, into *out; cudaErrorIllegalState where it captures none.
extern "C" int dliom_capture_kernels(void* stream, long long* out) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  *out = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id, &graph);
  if (err == cudaSuccess && (status != cudaStreamCaptureStatusActive || graph == nullptr)) {
    err = cudaErrorIllegalState;
  }
  if (err == cudaSuccess) err = count_kernels(graph, out);
  return static_cast<int>(err);
}

// An empty kernel: the floor under every launch. chip_smoke.py times one
// launch of it (replayed from a CUDA graph) beside K1's and K2's bounds,
// which sit below the cost of one launch. It replaces no TPU kernel and no
// path of the port calls it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int dliom_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

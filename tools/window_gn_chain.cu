// Latency of each kind of dependent step on K3's solve chain
// (dliom_tpu_torch/csrc/window_gn.cu, block_cholesky_solve), one warp
// walking a chain of `steps` of them (a multiple of 16); built and timed by
// tools/torch_window_gn_times.py with the kernels' nvcc flags.
//   kind 0, a Cholesky column: a shuffle, the IEEE quotient, an FMA;
//   kind 1, a triangular solve's column: a shuffle, a product, an FMA;
//   kind 2, an off-diagonal block's term of a solve: an FMA.
// The constants come in as arguments, so nothing folds; each step's
// value stays near 1 to 2.

#include <cuda_runtime.h>

template <int kKind>
__global__ void chain_kernel(int steps, float a, float c, float b, float* out) {
  float x = 1.0f + threadIdx.x * 1e-3f;
#pragma unroll 1
  for (int i = 0; i < steps; i += 16) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {  // unrolled as K3's chain is: no branch between steps
      if (kKind == 2) {
        x = fmaf(x, c, b);
      } else {
        const float p = __shfl_sync(0xffffffffu, x, k);
        x = kKind == 0 ? fmaf(a / p, c, b) : fmaf(p * a, c, b);
      }
    }
  }
  out[threadIdx.x] = x;
}

extern "C" int dliom_chain_latency(int kind, int steps, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) chain_kernel<0><<<1, 32, 0, s>>>(steps, 1.0f, 0.5f, 1.0f, out);
  else if (kind == 1) chain_kernel<1><<<1, 32, 0, s>>>(steps, 0.9f, 0.5f, 1.0f, out);
  else chain_kernel<2><<<1, 32, 0, s>>>(steps, 0.9f, 0.5f, 1.0f, out);
  return static_cast<int>(cudaGetLastError());
}

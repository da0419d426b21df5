// K2: IMU error-state affine chain on Hopper.
//
// Replaces the TPU Pallas kernel
// dliom_tpu/imu/preintegration.py::_pallas_affine_chain. Per chain b, from
// A = I and P = 0, for i = 1..M in order:
//     A <- F_i A,   P <- F_i P F_i^T + Q_i
// over 15x15 float32 blocks; masked samples arrive as (I, 0).
//
// What bounds it: the latency of M serial steps of 15x15 products (about
// 7 kFLOP each), not bytes or FLOP/s. Design: one CTA per chain with A, P,
// F_i and the temporary T = F_i P in shared memory, one thread per output
// element (225 of 256), the whole loop inside the block, and no
// device-memory traffic inside the loop other than reading F_i and Q_i.
// The kernel allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 15;
constexpr int kNN = kN * kN;
constexpr int kThreads = 256;

__global__ void affine_chain_kernel(const float* __restrict__ f, const float* __restrict__ q,
                                    float* __restrict__ a_out, float* __restrict__ p_out,
                                    int m) {
  __shared__ float s_a[kNN];
  __shared__ float s_p[kNN];
  __shared__ float s_t[kNN];
  __shared__ float s_f[kNN];
  const int tid = threadIdx.x;
  const bool active = tid < kNN;
  const int r = tid / kN;
  const int c = tid % kN;
  const float* fb = f + (int64_t)blockIdx.x * m * kNN;
  const float* qb = q + (int64_t)blockIdx.x * m * kNN;

  if (active) {
    s_a[tid] = (r == c) ? 1.0f : 0.0f;
    s_p[tid] = 0.0f;
  }
  for (int i = 0; i < m; ++i) {
    if (active) s_f[tid] = fb[(int64_t)i * kNN + tid];
    __syncthreads();
    float t = 0.0f;
    float a = 0.0f;
    if (active) {
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const float fk = s_f[r * kN + k];
        t += fk * s_p[k * kN + c];
        a += fk * s_a[k * kN + c];
      }
    }
    __syncthreads();
    if (active) {
      s_t[tid] = t;
      s_a[tid] = a;
    }
    __syncthreads();
    if (active) {
      float p = 0.0f;
#pragma unroll
      for (int k = 0; k < kN; ++k) p += s_t[r * kN + k] * s_f[c * kN + k];
      s_p[tid] = p + qb[(int64_t)i * kNN + tid];
    }
    __syncthreads();
  }
  if (active) {
    a_out[(int64_t)blockIdx.x * kNN + tid] = s_a[tid];
    p_out[(int64_t)blockIdx.x * kNN + tid] = s_p[tid];
  }
}

}  // namespace

extern "C" int dliom_affine_chain(const void* f, const void* q, void* a_out, void* p_out,
                                  int batch, int m, void* stream) {
  if (batch <= 0) return 0;
  affine_chain_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(q),
      static_cast<float*>(a_out), static_cast<float*>(p_out), m);
  return static_cast<int>(cudaGetLastError());
}

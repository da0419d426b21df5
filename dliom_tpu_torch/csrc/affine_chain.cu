// K2: IMU error-state affine chain on Hopper.
//
// Replaces the TPU Pallas kernel
// dliom_tpu/imu/preintegration.py::_pallas_affine_chain. Per chain b, from
// A = I and P = 0, for i = 1..M in order:
//     A <- F_i A,   P <- F_i P F_i^T + Q_i
// over 15x15 float32 blocks; masked samples arrive as (I, 0).
//
// What bounds it: neither bytes (2 x M x 900 B in) nor FLOP (M x 20 kFLOP):
// a chain run one sample after another is M dependent steps of 15x15
// products. Design: a scan over time. Sample i is the affine map
// (F_i, Q_i), and "a then b" is (F_b F_a, F_b Q_a F_b^T + Q_b), which is
// associative (the `combine` of the JAX package's associative_scan). One
// CTA per chain, kWarps warps:
//   * warp w composes a contiguous chunk of ceil(M / kWarps) samples in
//     order. Each warp stages its own samples into its own shared-memory
//     ring with cp.async (4-byte copies: a 15x15 block is 900 B, not
//     16-byte aligned), kRing samples ahead, so no device-memory load sits
//     inside the loop and any M fits;
//   * the chunk results combine in a log2(kWarps) tree, left to right;
//   * one composition is one warp, each lane a 4x2 tile of every product
//     (see compose): 360 FMA and 228 floats of shared-memory loads a lane,
//     with no bank conflict on the loads. With 16 warps composing at once
//     the chunk phase is bound by the SM's shared-memory bandwidth (128 B
//     per clock), so the tile is chosen for the fewest loads per FMA.
// At M = 48 the serial depth is 2 compositions per chunk plus 4 tree
// levels instead of 48 steps. Every sum runs over k in order with f32 FMA
// (no TF32, no tensor cores); the tree changes the association of the
// products, so the result agrees with the sequential plain version to
// rtol 1e-5 / atol 1e-6, not bit for bit. The kernel allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 15;
constexpr int kNN = kN * kN;
// Blocks sit in shared memory as 16 rows (row 15 is padding) of kLd
// floats: 16-byte aligned rows whose starts fall in distinct bank groups.
constexpr int kLd = 20;
constexpr int kMat = 16 * kLd;       // floats per padded block
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRing = 3;             // samples in flight per warp
// per warp: A, P, T, then kRing (F, Q) pairs
constexpr int kWarpFloats = (3 + 2 * kRing) * kMat;
constexpr size_t kSmemBytes = (size_t)kWarps * kWarpFloats * sizeof(float);

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage one sample (F_i, Q_i), 225 floats each, into padded blocks.
__device__ __forceinline__ void stage(float* f_dst, float* q_dst, const float* f_src,
                                      const float* q_src, int lane) {
  for (int e = lane; e < kNN; e += 32) {
    const int at = (e / kN) * kLd + e % kN;
    cp_async4(f_dst + at, f_src + e);
    cp_async4(q_dst + at, q_src + e);
  }
}

// The 16 floats of row r (the 16th is padding).
__device__ __forceinline__ void load_row(const float* m, int r, float (&out)[16]) {
  const float4* v = reinterpret_cast<const float4*>(m + r * kLd);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 x = v[q];
    out[4 * q] = x.x;
    out[4 * q + 1] = x.y;
    out[4 * q + 2] = x.z;
    out[4 * q + 3] = x.w;
  }
}

// One warp: (A, P) <- (F A, F P F^T + Q), with T as scratch. Lane
// (rb, cp) = (lane / 8, lane % 8) computes the 4x2 tile of rows 4i + rb
// (i < 4) and columns cp, cp + 8 of each product; row and column 15 are
// the padding, computed and never read. A quarter-warp (one rb) reads one
// row at a time, so the 16-byte row loads of F and T are broadcasts; the
// rows cp of F (phase 2) start 80 bytes apart, in 8 different 16-byte bank
// groups, so those loads do not conflict either.
__device__ void compose(float* a, float* p, float* t, const float* f, const float* q, int lane) {
  const int rb = lane >> 3;
  const int c0 = lane & 7;
  const int c1 = c0 + 8;
  float pc0[kN], pc1[kN], ac0[kN], ac1[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    pc0[k] = p[k * kLd + c0];
    pc1[k] = p[k * kLd + c1];
    ac0[k] = a[k * kLd + c0];
    ac1[k] = a[k * kLd + c1];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * i + rb;
    float fr[16];
    load_row(f, r, fr);
    float t0 = 0.0f, t1 = 0.0f, a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      t0 = fmaf(fr[k], pc0[k], t0);
      t1 = fmaf(fr[k], pc1[k], t1);
      a0 = fmaf(fr[k], ac0[k], a0);
      a1 = fmaf(fr[k], ac1[k], a1);
    }
    t[r * kLd + c0] = t0;
    t[r * kLd + c1] = t1;
    a[r * kLd + c0] = a0;
    a[r * kLd + c1] = a1;
  }
  __syncwarp();
  float f0[16], f1[16];
  load_row(f, c0, f0);
  load_row(f, c1, f1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * i + rb;
    float tr[16];
    load_row(t, r, tr);
    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      p0 = fmaf(tr[k], f0[k], p0);
      p1 = fmaf(tr[k], f1[k], p1);
    }
    p[r * kLd + c0] = p0 + q[r * kLd + c0];
    p[r * kLd + c1] = p1 + q[r * kLd + c1];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
    affine_chain_kernel(const float* __restrict__ f, const float* __restrict__ q,
                        float* __restrict__ a_out, float* __restrict__ p_out, int m) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = (m + kWarps - 1) / kWarps;
  const int first = warp * chunk;
  const int n = max(0, min(chunk, m - first));
  float* base = smem + warp * kWarpFloats;
  float* a = base;
  float* p = base + kMat;
  float* t = base + 2 * kMat;
  float* ring = base + 3 * kMat;
  const float* fb = f + ((int64_t)blockIdx.x * m + first) * kNN;
  const float* qb = q + ((int64_t)blockIdx.x * m + first) * kNN;

  // sample 0 of the chunk lands in (A, P) itself; sample j >= 1 in ring
  // slot (j - 1) % kRing. One commit group per sample, empty past the end.
  if (n > 0) stage(a, p, fb, qb, lane);
  cp_async_commit();
#pragma unroll
  for (int j = 1; j <= kRing; ++j) {
    if (j < n) {
      float* slot = ring + 2 * ((j - 1) % kRing) * kMat;
      stage(slot, slot + kMat, fb + (int64_t)j * kNN, qb + (int64_t)j * kNN, lane);
    }
    cp_async_commit();
  }
  for (int j = 1; j < n; ++j) {
    cp_async_wait<kRing - 1>();  // groups 0..j have landed
    __syncwarp();
    const float* slot = ring + 2 * ((j - 1) % kRing) * kMat;
    compose(a, p, t, slot, slot + kMat, lane);
    const int next = j + kRing;
    if (next < n) {
      float* dst = ring + 2 * ((next - 1) % kRing) * kMat;  // the slot just read
      stage(dst, dst + kMat, fb + (int64_t)next * kNN, qb + (int64_t)next * kNN, lane);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // tree over the chunks, left to right: chunk w then chunk w + span; the
  // chunks are filled from the left, so an empty right chunk ends the pair
  for (int span = 1; span < kWarps; span <<= 1) {
    if (warp % (2 * span) == 0 && (warp + span) * chunk < m) {
      const float* right = smem + (warp + span) * kWarpFloats;
      compose(a, p, t, right, right + kMat, lane);
    }
    __syncthreads();
  }

  if (warp == 0) {
    float* ao = a_out + (int64_t)blockIdx.x * kNN;
    float* po = p_out + (int64_t)blockIdx.x * kNN;
    for (int e = lane; e < kNN; e += 32) {
      const int at = (e / kN) * kLd + e % kN;
      ao[e] = m > 0 ? a[at] : (e / kN == e % kN ? 1.0f : 0.0f);
      po[e] = m > 0 ? p[at] : 0.0f;
    }
  }
}

}  // namespace

extern "C" int dliom_affine_chain(const void* f, const void* q, void* a_out, void* p_out,
                                  int batch, int m, void* stream) {
  if (batch <= 0) return 0;
  // The shared-memory attribute belongs to the current device's context:
  // set it once on every device the kernel launches on.
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(
        affine_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  affine_chain_kernel<<<batch, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(q),
      static_cast<float*>(a_out), static_cast<float*>(p_out), m);
  return static_cast<int>(cudaGetLastError());
}

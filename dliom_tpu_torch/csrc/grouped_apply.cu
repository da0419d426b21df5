// K1: grouped grid-update apply on Hopper.
//
// Replaces the TPU Pallas kernel dliom_tpu/ops/pallas_apply.py::apply_grouped_rows
// (body _make_kernel). For grid step i, the sorted records
// keys[starts[i]:ends[i]] (cell << 1 | is_hit) update block rows[i] of an
// int16 bank viewed as groups of `cells_per_group` cells: a cell with a hit
// record takes hit_table[v], else a cell with a miss record takes
// miss_table[v], else it keeps v ("update once, hits first",
// range_data_inserter_3d.cc:78-92). fresh[i] != 0 zero-fills the block first.
//
// What bounds it: bytes. Each touched block is read and written once and
// each record read once; there is no arithmetic to speak of. Design:
//   * one CTA per grid step; the TPU ran its grid in order, here the CTAs
//     run concurrently, so a step with an empty range and fresh == 0 (the
//     parking and pool-full steps, several of which share one parking row)
//     returns before touching memory. Non-empty steps own distinct rows.
//   * records set bits of two shared-memory bitsets (hit, miss) with
//     atomicOr; duplicate records collapse for free.
//   * cells move 8 at a time as 16-byte vectors; a vector with no record
//     bits in a non-fresh block is neither read nor written.
//   * the odds update is a lookup into two 32768-entry int16 tables built
//     by the plain compute_update_table, so the kernel does no float
//     arithmetic and FMA contraction cannot change a bit.
// The bank is updated in place. The kernel allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void grouped_apply_kernel(int16_t* __restrict__ bank,
                                     const int32_t* __restrict__ rows,
                                     const int32_t* __restrict__ starts,
                                     const int32_t* __restrict__ ends,
                                     const int32_t* __restrict__ fresh,
                                     const int32_t* __restrict__ keys,
                                     const int16_t* __restrict__ hit_table,
                                     const int16_t* __restrict__ miss_table,
                                     int cells_per_group) {
  extern __shared__ uint32_t bits[];
  const int step = blockIdx.x;
  const int s = starts[step];
  const int e = ends[step];
  const bool is_fresh = fresh[step] != 0;
  if (e <= s && !is_fresh) return;

  const int words = cells_per_group >> 5;
  uint32_t* hit = bits;
  uint32_t* miss = bits + words;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    hit[w] = 0u;
    miss[w] = 0u;
  }
  __syncthreads();

  const int cell_mask = cells_per_group - 1;
  for (int j = s + threadIdx.x; j < e; j += blockDim.x) {
    const int key = keys[j];
    const int cell = (key >> 1) & cell_mask;
    uint32_t* word = (key & 1) ? &hit[cell >> 5] : &miss[cell >> 5];
    atomicOr(word, 1u << (cell & 31));
  }
  __syncthreads();

  uint4* block = reinterpret_cast<uint4*>(bank + (int64_t)rows[step] * cells_per_group);
  const int vectors = cells_per_group >> 3;
  for (int c8 = threadIdx.x; c8 < vectors; c8 += blockDim.x) {
    const int shift = (c8 & 3) * 8;
    const uint32_t hb = (hit[c8 >> 2] >> shift) & 0xffu;
    const uint32_t mb = (miss[c8 >> 2] >> shift) & 0xffu;
    if (!is_fresh && (hb | mb) == 0u) continue;
    uint4 v = is_fresh ? make_uint4(0u, 0u, 0u, 0u) : block[c8];
    int16_t* cells = reinterpret_cast<int16_t*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int cur = cells[k];
      if ((hb >> k) & 1u) {
        cells[k] = hit_table[cur];
      } else if ((mb >> k) & 1u) {
        cells[k] = miss_table[cur];
      }
    }
    block[c8] = v;
  }
}

}  // namespace

extern "C" int dliom_grouped_apply(void* bank, const void* rows, const void* starts,
                                   const void* ends, const void* fresh, const void* keys,
                                   const void* hit_table, const void* miss_table,
                                   int num_steps, int cells_per_group, void* stream) {
  if (num_steps <= 0) return 0;
  const size_t smem = 2 * (size_t)(cells_per_group / 32) * sizeof(uint32_t);
  grouped_apply_kernel<<<num_steps, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(bank), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(fresh), static_cast<const int32_t*>(keys),
      static_cast<const int16_t*>(hit_table), static_cast<const int16_t*>(miss_table),
      cells_per_group);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dliom_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
//
// The dense-bank entry (pallas_apply.py::apply_grouped_updates, group id ==
// bank row) also needs the step tables (rows, starts, ends) and the count
// of dropped groups from the sorted packed keys. On the TPU these come from
// XLA ops and reach the kernel by scalar prefetch; here a block loads its
// own indices, so the tables are one more kernel: one CTA of 1024 threads,
// each warp a contiguous segment of the keys read as coalesced 16-byte
// vectors, two passes and a scan over the warps' head counts (see
// group_tables_kernel). What bounds it: the latency of two passes over the
// keys inside one SM (the keys are ~0.2 MB); it replaces ~30 small PyTorch
// launches and their host dispatch. (A first version gave each thread a
// contiguous run of keys: each warp load then touched 32 cache lines, and
// the dense entry took 37 us of device time on an H100 against 17 us with
// warp segments; PERF.md, Findings.) The apply kernel's CTAs run in no
// order, so it reads the tables in a second launch on the same stream.
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
  const bool is_fresh = fresh != nullptr && fresh[step] != 0;
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

constexpr int kTableThreads = 1024;
constexpr int kTableWarps = kTableThreads / 32;
constexpr int kChunk = 128;  // keys per warp step: one 16-byte vector a lane
constexpr int kUnroll = 4;   // warp steps whose loads are in flight together
constexpr int32_t kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// Keys j0..j0+3 (j0 a multiple of 4, the keys 16-byte aligned); keys at or
// past `hi` read as sentinels.
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ keys, int j0, int hi) {
  if (j0 + 3 < hi) return __ldg(reinterpret_cast<const int4*>(keys + j0));
  return make_int4(j0 < hi ? keys[j0] : kSentinel, j0 + 1 < hi ? keys[j0 + 1] : kSentinel,
                   j0 + 2 < hi ? keys[j0 + 2] : kSentinel, j0 + 3 < hi ? keys[j0 + 3] : kSentinel);
}

// Head bits (bit i: key j0 + i) of a lane's four keys. `carry` is the key
// before the warp step's first key; on return, the step's last key. A
// sentinel's group (2^31 - 1 >> shift) is never a valid key's group, so a
// valid key after a sentinel, or first of all, is a head.
__device__ __forceinline__ int head_bits(int4 v, int shift, int& carry) {
  const int lane = threadIdx.x & 31;
  int prev = __shfl_up_sync(kFull, v.w, 1);
  if (lane == 0) prev = carry;
  carry = __shfl_sync(kFull, v.w, 31);
  const int g0 = v.x >> shift, g1 = v.y >> shift, g2 = v.z >> shift, g3 = v.w >> shift;
  return (v.x != kSentinel && g0 != (prev >> shift)) | ((v.y != kSentinel && g1 != g0) << 1) |
         ((v.z != kSentinel && g2 != g1) << 2) | ((v.w != kSentinel && g3 != g2) << 3);
}

__device__ __forceinline__ int valid_count(int4 v) {
  return (v.x != kSentinel) + (v.y != kSentinel) + (v.z != kSentinel) + (v.w != kSentinel);
}

// The tables of ops/grouped_apply.py::build_group_tables for packed keys
// (group << shift | cell << 1 | is_hit, sentinel-padded), bit for bit: a
// head is a valid key whose group differs from the previous key's (or the
// first key); head r sits at step r < num_groups with starts[r] its
// position and ends[r] the position of head r + 1 (the first overflow head
// included) or n_valid; unused steps get (dummy_group, n_valid, n_valid).
// dropped = max(heads - num_groups, 0).
//
// Warp w owns a contiguous segment of the keys, a multiple of kChunk long,
// read as 16-byte vectors, kUnroll warp steps in flight. Pass 1 counts its
// heads and valid keys; a scan over the 32 warp counts gives each warp its
// first rank; pass 2 reads the segment again (from cache) and each head
// writes its step, its rank from a warp scan of the per-lane head counts.
__global__ void __launch_bounds__(kTableThreads) group_tables_kernel(
    const int32_t* __restrict__ keys, int n, int shift, int num_groups, int dummy_group,
    int32_t* __restrict__ rows, int32_t* __restrict__ starts, int32_t* __restrict__ ends,
    int32_t* __restrict__ dropped) {
  __shared__ int warp_heads[kTableWarps];
  __shared__ int warp_valid[kTableWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = (n + kTableWarps * kChunk - 1) / (kTableWarps * kChunk) * kChunk;
  const int lo = min(n, warp * seg);
  const int hi = min(n, lo + seg);
  const int carry0 = lo > 0 ? keys[lo - 1] : kSentinel;

  int heads = 0;
  int valid = 0;
  int carry = carry0;
  for (int base = lo; base < hi; base += kUnroll * kChunk) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load4(keys, base + u * kChunk + 4 * lane, hi);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      heads += __popc(head_bits(v[u], shift, carry));
      valid += valid_count(v[u]);
    }
  }
  heads = __reduce_add_sync(kFull, heads);
  valid = __reduce_add_sync(kFull, valid);
  if (lane == 0) {
    warp_heads[warp] = heads;
    warp_valid[warp] = valid;
  }
  __syncthreads();

  // every warp scans the 32 warp counts itself
  int h = warp_heads[lane];
  int vsum = warp_valid[lane];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, h, d);
    if (lane >= d) h += up;
  }
  vsum = __reduce_add_sync(kFull, vsum);
  const int heads_total = __shfl_sync(kFull, h, 31);
  const int n_valid = vsum;
  int rank = __shfl_sync(kFull, h, warp) - heads;  // this warp's first rank

  carry = carry0;
  for (int base = lo; base < hi; base += kUnroll * kChunk) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load4(keys, base + u * kChunk + 4 * lane, hi);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int bits = head_bits(v[u], shift, carry);
      const int cnt = __popc(bits);
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      int r = rank + incl - cnt;
      const int j0 = base + u * kChunk + 4 * lane;
      const int vals[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (bits >> i & 1) {
          if (r < num_groups) {
            rows[r] = vals[i] >> shift;
            starts[r] = j0 + i;
          }
          if (r >= 1 && r <= num_groups) ends[r - 1] = j0 + i;
          ++r;
        }
      }
      rank += __shfl_sync(kFull, incl, 31);
    }
  }
  for (int r = threadIdx.x; r < num_groups; r += kTableThreads) {
    if (r >= heads_total) {
      rows[r] = dummy_group;
      starts[r] = n_valid;
      ends[r] = n_valid;
    } else if (r == heads_total - 1) {
      ends[r] = n_valid;  // the last head: no head r + 1
    }
  }
  if (threadIdx.x == 0) *dropped = max(heads_total - num_groups, 0);
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

// The dense-bank entry: the table kernel, then the apply kernel (no fresh
// steps), both on `stream`. `scratch` holds 3 * num_groups + 1 int32: rows,
// starts, ends, then dropped.
extern "C" int dliom_grouped_apply_dense(void* bank, const void* keys, int num_keys,
                                         const void* hit_table, const void* miss_table,
                                         void* scratch, int num_groups, int cells_per_group,
                                         int shift, int dummy_group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* rows = static_cast<int32_t*>(scratch);
  int32_t* starts = rows + num_groups;
  int32_t* ends = starts + num_groups;
  group_tables_kernel<<<1, kTableThreads, 0, s>>>(static_cast<const int32_t*>(keys), num_keys,
                                                  shift, num_groups, dummy_group, rows, starts,
                                                  ends, ends + num_groups);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_groups <= 0) return static_cast<int>(err);
  const size_t smem = 2 * (size_t)(cells_per_group / 32) * sizeof(uint32_t);
  grouped_apply_kernel<<<num_groups, kThreads, smem, s>>>(
      static_cast<int16_t*>(bank), rows, starts, ends, nullptr,
      static_cast<const int32_t*>(keys), static_cast<const int16_t*>(hit_table),
      static_cast<const int16_t*>(miss_table), cells_per_group);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dliom_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

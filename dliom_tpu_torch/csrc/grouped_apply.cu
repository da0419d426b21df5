// K1: grouped grid-update apply on Hopper.
//
// Replaces the TPU Pallas kernel dliom_tpu/ops/pallas_apply.py::apply_grouped_rows
// (body _make_kernel) and its dense-bank entry apply_grouped_updates. For
// grid step i, the records keys[starts[i]:ends[i]] (cell << 1 | is_hit)
// update block rows[i] of an int16 bank viewed as groups of
// `cells_per_group` cells: a cell with a hit record takes hit_table[v],
// else a cell with a miss record takes miss_table[v], else it keeps v
// ("update once, hits first", range_data_inserter_3d.cc:78-92).
// fresh[i] != 0 zero-fills the block first.
//
// What bounds it: not the bytes counted as the bound (the records, 4 B
// each, and one 2-byte read and write per distinct touched cell: 0.1-1 us
// of HBM time at the bench shapes, below the cost of one launch). Each
// touched cell is a scattered 2-byte access that moves a 32-byte sector
// in and out. At the single-slot-pair bench shapes (~45k records) the time
// is the launch plus a chain of dependent memory trips (step tables ->
// keys -> bank cell -> lookup table -> store); at the batched step's 16
// slots (~345k records over a 1 GiB bank) it is that sector traffic, and
// a PyTorch gather and scatter of the same cells takes longer than the
// whole kernel (PERF.md, Findings). So the design keeps the chain short,
// issues each trip for many records at once, and does no work that grows
// with cells_per_group or with empty steps. Asynchronous copies (cp.async,
// TMA) would stage only the keys, which are read once, coalesced, by the
// warp that uses them: they buy nothing here.
//
// Apply (dliom_grouped_apply): one CTA of kBrickWarps warps per grid step.
//   * A step with an empty range and fresh == 0 (parking and pool-full
//     steps, several of which share one parking row) reads its 16 bytes of
//     table and exits. Steps with records, or fresh, own distinct rows.
//   * The warps take the step's range in windows of kWindow records, one
//     window each per round: a step of up to 256 records takes one round.
//     Each lane loads its records and their neighbours (coalesced, the
//     neighbours from L1), so a window needs no shuffles, only two ballots
//     per row of 32.
//   * No group-wide bitset: the update is decided per run of equal cells.
//     This relies on each cell's records being contiguous within a step's
//     range, which both callers give: mapping/brick_grid.py sorts the
//     records by (group, cell, kind) and ops/grid_update.py sorts the
//     packed keys. They put a cell's hit records at opposite ends of its
//     run (the brick keys s_sec ^ 1 first, the ascending dense keys last),
//     so no record's position decides: the run's last record owns the
//     cell and takes the OR of the run's hit bits, computed from the rows'
//     ballots (run heads and hits) and a carry across rows. A window also
//     reads the 32 records before it, which give the carry of a run that
//     began earlier; a run longer than that is scanned back, 32 a load.
//   * Each owner reads its cell, looks the new value up in one of two
//     32768-entry int16 tables built by the plain compute_update_table (no
//     float arithmetic in the kernel, so FMA contraction cannot change a
//     bit) and writes it: one read and one write per distinct cell.
//   * A fresh step's CTA zero-fills the group with 16-byte stores, then
//     __syncthreads() orders the fill before its owners write table[0]
//     values; no other step writes that row.
//
// Dense entry (dliom_grouped_apply_dense): one launch over the sorted
// packed keys (group << cell_bits | cell << 1 | is_hit, sentinel-padded,
// group id == bank row), in tiles of kDenseWarps x 32 x kDenseSub keys.
// A group of rank >= num_groups (rank: distinct groups before it) is
// dropped whole, and `dropped` counts them. Each tile counts its group
// heads; a decoupled look-back across tiles (tile order from an atomic
// ticket, so every tile a CTA waits on is already running) gives each tile
// the heads before it, hence each record's rank. The bank loads and table
// lookups are issued before the look-back; only the stores wait for it.
// A run of equal (group, cell) may start in an earlier tile: the window
// that holds its last record scans back over it, 32 keys per load. The
// look-back status words carry an epoch that the last tile to finish
// advances (with the ticket and finish counters reset), so the scratch
// needs no clearing launch between calls; calls on one stream share it.
// The bank is updated in place. Neither kernel allocates anything.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kSentinel = 0x7fffffff;
constexpr int kBrickWarps = 4;  // warps per grid step (one CTA)
constexpr int kBrickRows = 2;   // rows of 32 records per window
constexpr int kWindow = 32 * kBrickRows;
constexpr int kDenseWarps = 4;
constexpr int kDenseSub = 4;
constexpr int kDenseTile = kDenseWarps * 32 * kDenseSub;
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kInclusive = 2u << 30;
constexpr uint32_t kValueMask = kAggregate - 1;

__device__ __forceinline__ unsigned lanemask_le() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_le;" : "=r"(m));
  return m;
}

// For one row of 32 records: `heads` marks run heads, `hits` hit records
// (ballots), `carry` the OR of hits of the run open before the row. Returns
// the OR of hits over this lane's run up to and including the lane, and
// moves `carry` to the run open at the row's end.
__device__ __forceinline__ bool run_or(unsigned heads, unsigned hits, bool& carry) {
  const unsigned le = lanemask_le();
  const unsigned h = heads & le;
  const bool mine = h ? ((hits & le) >> (31 - __clz(h))) != 0u : (carry || (hits & le) != 0u);
  carry = heads ? (hits >> (31 - __clz(heads))) != 0u : (carry || hits != 0u);
  return mine;
}

// The cell of record j of the range [s, e), or -1 outside it.
__device__ __forceinline__ int cell_at(const int32_t* __restrict__ keys, int j, int s, int e,
                                       int mask) {
  return j >= s && j < e ? (keys[j] >> 1) & mask : -1;
}

__global__ void __launch_bounds__(kBrickWarps * 32) grouped_apply_kernel(
    int16_t* __restrict__ bank, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ fresh, const int32_t* __restrict__ keys,
    const int16_t* __restrict__ hit_table, const int16_t* __restrict__ miss_table,
    int cells_per_group) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int step = blockIdx.x;
  const int s = starts[step];
  const int e = ends[step];
  const bool is_fresh = fresh[step] != 0;
  const int row = rows[step];
  if (e <= s && !is_fresh) return;
  int16_t* __restrict__ group = bank + (int64_t)row * cells_per_group;
  if (is_fresh) {
    uint4* v = reinterpret_cast<uint4*>(group);
    for (int i = threadIdx.x; i < (cells_per_group >> 3); i += kBrickWarps * 32) {
      v[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();  // the fill before any owner's write
  }
  const int mask = cells_per_group - 1;
  for (int base = s + warp * kWindow; base < e; base += kBrickWarps * kWindow) {
    // Entry r holds record base + 32 (r - 1) + lane: entry 0, the 32
    // records before the window, gives the hits of the run open at base - 1.
    int cell[kBrickRows + 1], prev[kBrickRows + 1], next[kBrickRows + 1];
    bool hit[kBrickRows + 1];
#pragma unroll
    for (int r = 0; r <= kBrickRows; ++r) {
      const int j = base + 32 * (r - 1) + lane;
      const int key = j >= s && j < e ? keys[j] : -1;
      cell[r] = key < 0 ? -1 : (key >> 1) & mask;
      hit[r] = key >= 0 && (key & 1);
      prev[r] = cell_at(keys, j - 1, s, e, mask);
      next[r] = cell_at(keys, j + 1, s, e, mask);
    }
    bool carry = false, owner[kBrickRows + 1], any[kBrickRows + 1];
    unsigned heads[kBrickRows + 1], hits[kBrickRows + 1];
#pragma unroll
    for (int r = 0; r <= kBrickRows; ++r) {
      heads[r] = __ballot_sync(kFull, cell[r] >= 0 && cell[r] != prev[r]);
      hits[r] = __ballot_sync(kFull, hit[r]);
    }
    // a run open at base - 1 that began before row -1: scan back over it
    if (heads[0] == 0u && hits[0] == 0u && base - 32 > s) {
      const int run = __shfl_sync(kFull, cell[0], 0);
      for (int p = base - 64;; p -= 32) {
        const int c = cell_at(keys, p + lane, s, e, mask);
        carry = __ballot_sync(kFull, c == run && (keys[max(p + lane, 0)] & 1)) != 0u;
        if (carry || __ballot_sync(kFull, c != run) != 0u) break;
      }
    }
#pragma unroll
    for (int r = 0; r <= kBrickRows; ++r) {
      any[r] = run_or(heads[r], hits[r], carry);
      owner[r] = r > 0 && cell[r] >= 0 && cell[r] != next[r];
    }
    int16_t cur[kBrickRows + 1];
#pragma unroll
    for (int r = 1; r <= kBrickRows; ++r) cur[r] = owner[r] && !is_fresh ? group[cell[r]] : 0;
#pragma unroll
    for (int r = 1; r <= kBrickRows; ++r) {
      if (owner[r]) group[cell[r]] = any[r] ? hit_table[cur[r]] : miss_table[cur[r]];
    }
  }
}

__device__ __forceinline__ uint32_t status_word_hi(unsigned long long w) { return (uint32_t)(w >> 32); }

// The heads of all tiles before `tile` (warp 0 of the CTA; lane i reads
// tile - 1 - i, 32 tiles per round, until a tile with its inclusive prefix).
__device__ __forceinline__ int look_back(const unsigned long long* status, int tile, uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  int prefix = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int t = pred - lane;
    uint32_t lo = kInclusive;  // before tile 0: inclusive 0
    if (t >= 0) {
      const volatile unsigned long long* p = status + t;
      unsigned long long w;
      do {
        w = *p;
      } while (status_word_hi(w) != epoch || ((uint32_t)w & ~kValueMask) == 0u);
      lo = (uint32_t)w;
    }
    const unsigned inclusive = __ballot_sync(kFull, (lo & ~kValueMask) == kInclusive);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    prefix += __reduce_add_sync(kFull, lane <= stop ? (lo & kValueMask) : 0u);
    if (inclusive) return prefix;
  }
}

__global__ void __launch_bounds__(kDenseWarps * 32) dense_apply_kernel(
    int16_t* __restrict__ bank, const int32_t* __restrict__ keys, int n,
    const int16_t* __restrict__ hit_table, const int16_t* __restrict__ miss_table,
    int num_groups, int cell_bits, int num_tiles, uint32_t* ctrl, unsigned long long* status,
    int32_t* __restrict__ dropped) {
  __shared__ int s_tile, s_prefix;
  __shared__ uint32_t s_epoch;
  __shared__ int s_heads[kDenseWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = (int)atomicAdd(&ctrl[0], 1u);
    s_epoch = *reinterpret_cast<volatile uint32_t*>(&ctrl[2]);
  }
  __syncthreads();
  const int tile = s_tile;
  const uint32_t epoch = s_epoch;
  const int base = tile * kDenseTile + warp * 32 * kDenseSub;

  int key[kDenseSub];
#pragma unroll
  for (int u = 0; u < kDenseSub; ++u) {
    const int j = base + 32 * u + lane;
    key[u] = j < n ? keys[j] : kSentinel;
  }
  const int before = base > 0 && base - 1 < n ? keys[base - 1] : -1;  // -1: no record
  const int after = base + 32 * kDenseSub < n ? keys[base + 32 * kDenseSub] : kSentinel;
  unsigned gheads[kDenseSub], rheads[kDenseSub], hits[kDenseSub], lasts[kDenseSub];
#pragma unroll
  for (int u = 0; u < kDenseSub; ++u) {
    int up = __shfl_up_sync(kFull, key[u], 1);
    const int last_of_prev_row = u > 0 ? __shfl_sync(kFull, key[u - 1], 31) : before;
    if (lane == 0) up = last_of_prev_row;
    int down = __shfl_down_sync(kFull, key[u], 1);
    const int first_of_next_row = u + 1 < kDenseSub ? __shfl_sync(kFull, key[u + 1], 0) : after;
    if (lane == 31) down = first_of_next_row;
    const bool valid = key[u] != kSentinel;
    gheads[u] = __ballot_sync(kFull, valid && (key[u] >> cell_bits) != (up >> cell_bits));
    rheads[u] = __ballot_sync(kFull, valid && (key[u] >> 1) != (up >> 1));
    hits[u] = __ballot_sync(kFull, valid && (key[u] & 1));
    lasts[u] = __ballot_sync(kFull, valid && (key[u] >> 1) != (down >> 1));
  }

  // The window's first run began before it: if its last record is here,
  // OR in the hits of its earlier records (scan back, 32 keys a load).
  bool carry = false;
  int first_head = 32 * kDenseSub, first_last = 32 * kDenseSub;
#pragma unroll
  for (int u = kDenseSub - 1; u >= 0; --u) {
    if (rheads[u]) first_head = 32 * u + __ffs(rheads[u]) - 1;
    if (lasts[u]) first_last = 32 * u + __ffs(lasts[u]) - 1;
  }
  if (first_head > 0 && first_last < first_head) {
    const int run = __shfl_sync(kFull, key[0], 0) >> 1;
    for (int p = base - 32;; p -= 32) {
      const int j = p + lane;
      const int k = j >= 0 ? keys[j] : -1;
      const bool same = (k >> 1) == run;
      carry = __ballot_sync(kFull, same && (k & 1)) != 0u;
      if (carry || __ballot_sync(kFull, !same) != 0u) break;
    }
  }

  // per record: its run's hit OR, whether it owns the cell, its group rank
  // within the warp (heads up to and including it, minus one)
  bool any[kDenseSub];
  int rank[kDenseSub];
  int heads = 0;
  const unsigned le = lanemask_le();
#pragma unroll
  for (int u = 0; u < kDenseSub; ++u) {
    any[u] = run_or(rheads[u], hits[u], carry);
    rank[u] = heads + __popc(gheads[u] & le) - 1;
    heads += __popc(gheads[u]);
  }
  // loads and lookups before the look-back; only the stores wait for it
  int16_t val[kDenseSub];
#pragma unroll
  for (int u = 0; u < kDenseSub; ++u) {
    if ((lasts[u] >> lane) & 1u) {
      const int16_t cur = bank[key[u] >> 1];
      val[u] = any[u] ? hit_table[cur] : miss_table[cur];
    }
  }
  if (lane == 0) s_heads[warp] = heads;
  __syncthreads();
  int warp_prefix = 0, tile_heads = 0;
#pragma unroll
  for (int w = 0; w < kDenseWarps; ++w) {
    warp_prefix += w < warp ? s_heads[w] : 0;
    tile_heads += s_heads[w];
  }
  if (warp == 0) {
    if (lane == 0) {
      const uint32_t flag = tile == 0 ? kInclusive : kAggregate;
      atomicExch(status + tile, (unsigned long long)epoch << 32 | flag | (uint32_t)tile_heads);
    }
    const int prefix = tile == 0 ? 0 : look_back(status, tile, epoch);
    if (lane == 0) {
      if (tile > 0) {
        atomicExch(status + tile, (unsigned long long)epoch << 32 | kInclusive |
                                      (uint32_t)(prefix + tile_heads));
      }
      if (tile == num_tiles - 1) *dropped = max(prefix + tile_heads - num_groups, 0);
      s_prefix = prefix;
    }
  }
  __syncthreads();
  const int first_rank = s_prefix + warp_prefix;
#pragma unroll
  for (int u = 0; u < kDenseSub; ++u) {
    if (((lasts[u] >> lane) & 1u) && first_rank + rank[u] < num_groups) bank[key[u] >> 1] = val[u];
  }
  // the last tile to finish resets the tickets and advances the epoch
  if (threadIdx.x == 0 && atomicAdd(&ctrl[1], 1u) == (uint32_t)num_tiles - 1) {
    ctrl[0] = 0u;
    ctrl[1] = 0u;
    ctrl[2] = epoch + 1u;
  }
}

}  // namespace

extern "C" int dliom_grouped_apply(void* bank, const void* rows, const void* starts,
                                   const void* ends, const void* fresh, const void* keys,
                                   const void* hit_table, const void* miss_table,
                                   int num_steps, int cells_per_group, void* stream) {
  if (num_steps <= 0) return 0;
  grouped_apply_kernel<<<num_steps, kBrickWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(bank), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(fresh), static_cast<const int32_t*>(keys),
      static_cast<const int16_t*>(hit_table), static_cast<const int16_t*>(miss_table),
      cells_per_group);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dliom_dense_tile_keys() { return kDenseTile; }

// The dense-bank entry, one launch on `stream`. `lookback` is the
// stream's look-back scratch: 4 uint32 (ticket, finished, epoch, pad),
// then one 8-byte status word per tile; zeroed once when allocated, it is
// left ready for the next call by the last tile. `dropped` is one int32.
extern "C" int dliom_grouped_apply_dense(void* bank, const void* keys, int num_keys,
                                         const void* hit_table, const void* miss_table,
                                         void* lookback, int num_tiles, void* dropped,
                                         int num_groups, int cell_bits, void* stream) {
  uint32_t* ctrl = static_cast<uint32_t*>(lookback);
  dense_apply_kernel<<<num_tiles, kDenseWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(bank), static_cast<const int32_t*>(keys), num_keys,
      static_cast<const int16_t*>(hit_table), static_cast<const int16_t*>(miss_table),
      num_groups, cell_bits, num_tiles, ctrl, reinterpret_cast<unsigned long long*>(ctrl + 4),
      static_cast<int32_t*>(dropped));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dliom_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

"""Two-level brick probability grid, the HybridGrid analog (port of
dliom_tpu/mapping/brick_grid.py; reference mapping/3d/hybrid_grid.h).

  * directory: (2 * num_dir_groups,) int32 — Morton-coded brick group ->
    epoch-tagged pool group `(epoch << pg_bits) | pool_group`, or -1;
  * pool: (2 * num_pool_cells,) int16 — the allocated groups' cells.

Insertion takes one of two paths. With `apply_groups > 0` (grouped),
allocation and directory upkeep run per touched group and the cell updates
go through kernel K1 (ops/grouped_apply.py); the pool's last group per slot
is K1's parking row. With `apply_groups == 0` (per record, the JAX
package's XLA fallback), every record looks up and allocates its group
itself and the first record of each touched cell writes the cell's one
update; every pool group can be allocated, and a reset clears the slot's
directory and pool for real.

Banks are updated in place: `reset_slot` writes the directory (and the
pool on the per-record path) and `_insert_brick_slots` the directory,
`group_of_slot` and the pool of the bank it is given, and both return a
BrickBank that shares those tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.lio.mapping import probability as pv
from benchmark.reference.lio.mapping.grid import GRID_DTYPE, smoothstep_trilinear
from benchmark.reference.lio.ops.grid_update import _trunc_div
from benchmark.reference.lio.ops.morton import part1by2

BRICK = 8
BRICK_CELLS = BRICK * BRICK * BRICK


class BrickGridSpec(NamedTuple):
    """Static geometry."""

    resolution: float
    dir_extent: int  # bricks per axis in the directory
    max_bricks: int  # pool capacity per slot (in bricks)
    apply_groups: int = 0  # per-insert touched-group capacity of K1
    apply_group_bricks: int = 32  # bricks per allocation/kernel group

    @property
    def extent(self) -> int:
        return self.dir_extent * BRICK

    @property
    def half(self) -> int:
        return self.extent // 2

    @property
    def morton_bits(self) -> int:
        assert self.dir_extent <= 1024, "dir_extent > 1024 exceeds Morton range"
        return max(1, int(self.dir_extent - 1).bit_length())

    @property
    def alloc_bricks(self) -> int:
        g = min(self.apply_group_bricks, self.max_bricks)
        assert g & (g - 1) == 0 and self.max_bricks % g == 0
        assert self.apply_groups == 0 or g == self.apply_group_bricks
        return g

    @property
    def cells_per_group(self) -> int:
        return self.alloc_bricks * BRICK_CELLS

    @property
    def num_dir_groups(self) -> int:
        return (1 << (3 * self.morton_bits)) // self.alloc_bricks

    @property
    def num_pool_groups(self) -> int:
        return self.max_bricks // self.alloc_bricks

    @property
    def pg_bits(self) -> int:
        return max(1, int(self.num_pool_groups - 1).bit_length())

    @property
    def epoch_mask(self) -> int:
        """Largest storable slot epoch (entries stay non-negative int32)."""
        return (1 << (31 - self.pg_bits)) - 1

    @property
    def sweep_per_reset(self) -> int:
        """Directory entries cleared per reset_slot so every entry is
        rewritten at least once per epoch-wrap period."""
        return -(-self.num_dir_groups // (self.epoch_mask + 1))

    @property
    def num_pool_cells(self) -> int:
        return self.max_bricks * BRICK_CELLS


class BrickBank(NamedTuple):
    """Two-slot active-submap bank; all arrays flat, slot-offset indexed."""

    directory: torch.Tensor  # (2 * num_dir_groups,) int32 epoch-tagged entry
    pool: torch.Tensor  # (2 * num_pool_cells,) int16
    counts: torch.Tensor  # (2,) int32 allocated groups per slot
    group_of_slot: torch.Tensor  # (2 * num_pool_groups,) int32
    dropped: torch.Tensor  # (1,) int32 running count of dropped groups ((B,) batched, in [0])
    epochs: torch.Tensor  # (2,) int32 per-slot spawn epoch


def make_brick_bank(spec: BrickGridSpec, device=None, lanes: int = 1) -> BrickBank:
    """An empty bank of two slots per lane."""
    i32 = dict(dtype=torch.int32, device=device)
    slots = 2 * lanes
    return BrickBank(
        directory=torch.full((slots * spec.num_dir_groups,), -1, **i32),
        pool=torch.zeros(slots * spec.num_pool_cells, dtype=GRID_DTYPE, device=device),
        counts=torch.zeros(slots, **i32),
        group_of_slot=torch.zeros(slots * spec.num_pool_groups, **i32),
        dropped=torch.zeros(lanes, **i32),
        epochs=torch.zeros(slots, **i32),
    )


def _decode_dir(raw: torch.Tensor, epoch: torch.Tensor, spec: BrickGridSpec):
    """Epoch-tagged entry -> (pool group, currently allocated?)."""
    ok = (raw >= 0) & ((raw >> spec.pg_bits) == epoch)
    return raw & ((1 << spec.pg_bits) - 1), ok


def _encode_dir(pg: torch.Tensor, epoch: torch.Tensor, spec: BrickGridSpec):
    return (epoch << spec.pg_bits) | pg


def _morton_brick(brick: torch.Tensor) -> torch.Tensor:
    return part1by2(brick[..., 0]) | (part1by2(brick[..., 1]) << 1) | (part1by2(brick[..., 2]) << 2)


def _split_cells(cells: torch.Tensor, spec: BrickGridSpec):
    """Signed cell coords (..., 3) -> (dir_group, cell_in_group, in_bounds)."""
    shifted = cells + spec.half
    ok = torch.all((shifted >= 0) & (shifted < spec.extent), dim=-1)
    shifted = torch.clamp(shifted, 0, spec.extent - 1)
    brick = torch.div(shifted, BRICK, rounding_mode="floor")
    off = shifted - brick * BRICK
    mcode = _morton_brick(brick)
    off_lin = (off[..., 0] * BRICK + off[..., 1]) * BRICK + off[..., 2]
    ab = spec.alloc_bricks
    group = torch.div(mcode, ab, rounding_mode="floor")
    cig = torch.remainder(mcode, ab) * BRICK_CELLS + off_lin
    return group, cig, ok


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor, without a host read."""
    return x.index_select(0, i.reshape(1).long())[0]


def lookup_value_brick(bank: BrickBank, cells: torch.Tensor, spec: BrickGridSpec, slot) -> torch.Tensor:
    """Cell value at signed cell indices; 0 (unknown) when out of range or
    in an unallocated group. `slot` is one bank slot, or a tensor of slots
    that broadcasts against the cells' leading axes (one per lane)."""
    slot = torch.as_tensor(slot, dtype=torch.int32, device=cells.device)
    group, cig, ok = _split_cells(cells, spec)
    raw = bank.directory[(slot * spec.num_dir_groups + group).long()]
    epoch = _take(bank.epochs, slot) if slot.dim() == 0 else bank.epochs[slot.long()]
    pg, cur = _decode_dir(raw, epoch, spec)
    addr = (
        slot.long() * spec.num_pool_cells
        + torch.clamp(pg, 0, spec.num_pool_groups - 1).long() * spec.cells_per_group
        + cig
    )
    v = bank.pool[addr].to(torch.int32)
    return torch.where(ok & cur, v, 0)


def interpolated_probability_brick(bank: BrickBank, points: torch.Tensor, spec: BrickGridSpec,
                                   slot) -> torch.Tensor:
    """Smoothstep-trilinear probability (InterpolatedGrid::GetProbability,
    see grid.smoothstep_trilinear)."""
    return smoothstep_trilinear(
        points, spec.resolution, lambda cells: lookup_value_brick(bank, cells, spec, slot))


def reset_slot(bank: BrickBank, spec: BrickGridSpec, slot, pending=True) -> BrickBank:
    """Recycle a slot for a new submap, gated arithmetically on `pending`.
    `slot` and `pending` are one slot and flag, or (L,) tensors: one
    distinct slot per lane of a bank of 2L slots. Grouped path: bumps the
    slot's epoch through epoch_mask (invalidating every entry of the old
    epoch) and clears `sweep_per_reset` rotating directory entries so a
    wrapped epoch never false-validates a stale entry; the pool's stale
    cells stay, unreachable until K1 zero-fills a re-allocated group
    (`fresh`). Per-record path: the slot's directory becomes -1 and its
    pool 0, written in place through (slots, ·) views of the banks with no
    host read."""
    dev = bank.counts.device
    num_slots = bank.counts.shape[0]
    slot = torch.as_tensor(slot, dtype=torch.int32, device=dev)
    pending = torch.as_tensor(pending, device=dev).expand(slot.shape)
    in_slot = torch.arange(num_slots, dtype=torch.int32, device=dev) == slot[..., None]
    here = torch.any(in_slot & pending[..., None], dim=0) if slot.dim() else in_slot & pending
    counts = torch.where(here, 0, bank.counts)
    if spec.apply_groups <= 0:
        bank.directory.view(num_slots, spec.num_dir_groups).masked_fill_(here[:, None], -1)
        bank.pool.view(num_slots, spec.num_pool_cells).masked_fill_(here[:, None], 0)
        return bank._replace(counts=counts)
    epochs = torch.where(here, (bank.epochs + 1) & spec.epoch_mask, bank.epochs)
    k = spec.sweep_per_reset
    old_epoch = _take(bank.epochs, slot) if slot.dim() == 0 else bank.epochs[slot.long()]
    start = (old_epoch * k)[..., None]
    idx = (slot[..., None] * spec.num_dir_groups
           + torch.remainder(start + torch.arange(k, dtype=torch.int32, device=dev),
                             spec.num_dir_groups)).long()
    bank.directory[idx] = torch.where(pending[..., None], -1, bank.directory[idx])
    return bank._replace(counts=counts, epochs=epochs)


def add_to_first(counter: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """counter[0] + inc, the rest of `counter` unchanged: a bank's drop
    counter is (lanes,) and aggregates in element 0 (the JAX package's
    convention, which keeps the shape shardable)."""
    if counter.shape[0] == 1:
        return counter + inc
    return torch.cat([counter[:1] + inc, counter[1:]])


def _scatter_(target: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, keep: torch.Tensor) -> None:
    """target[idx[keep]] = vals[keep] in place, without a host read (JAX's
    scatter with mode="drop"). The kept indices must be distinct. Entries
    not kept write the final value of one fixed index (the first kept one,
    else index 0) to that index, so every write to it agrees."""
    any_keep = torch.any(keep)
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    park_idx = torch.where(any_keep, idx[first], 0)
    park_val = torch.where(any_keep, vals[first], target[:1])
    target[torch.where(keep, idx, park_idx).long()] = torch.where(keep, vals, park_val)


def _insert_brick_slots(
    bank: BrickBank,
    origins: torch.Tensor,  # (S, 3) per-slot origins in the slot frame
    hits: torch.Tensor,  # (S, N, 3)
    masks: torch.Tensor,  # (S, N)
    *,
    spec: BrickGridSpec,
    hit_probability: float,
    miss_probability: float,
    num_free_space_voxels: int,
) -> BrickBank:
    """One RangeDataInserter3D step into S slots with group allocation:
    every touched cell updates at most once, hits beating misses
    (range_data_inserter_3d.cc:78-92). Updates the bank in place."""
    hit_odds = hit_probability / (1.0 - hit_probability)
    miss_odds = miss_probability / (1.0 - miss_probability)
    k = int(num_free_space_voxels)
    res = spec.resolution
    dev = hits.device

    hit_cells = torch.round(hits / res).to(torch.int32)
    origin_cell = torch.round(origins / res).to(torch.int32)[:, None, :]
    delta = hit_cells - origin_cell
    num_samples = torch.amax(torch.abs(delta), dim=-1)  # (S, N)

    g_all, c_all, v_all, m_all = [], [], [], []
    group, cig, ok = _split_cells(hit_cells, spec)
    g_all.append(group); c_all.append(cig); v_all.append(masks & ok)
    m_all.append(torch.zeros_like(group))
    n = num_samples[..., None]
    safe_n = torch.clamp(n, min=1)
    for j in range(1, k + 1):
        cells = origin_cell + _trunc_div(delta * (n - j), safe_n)
        group, cig, ok = _split_cells(cells, spec)
        g_all.append(group); c_all.append(cig); v_all.append(masks & (num_samples >= j) & ok)
        m_all.append(torch.ones_like(group))

    s_count = hits.shape[0]
    slot_of = torch.arange(s_count, dtype=torch.int32, device=dev)[:, None].expand(hits.shape[:2])
    g_lin = torch.cat([x.reshape(-1) for x in g_all])
    cig = torch.cat([x.reshape(-1) for x in c_all])
    valid = torch.cat([x.reshape(-1) for x in v_all])
    is_miss = torch.cat([x.reshape(-1) for x in m_all])
    slot = slot_of.reshape(-1).repeat(k + 1)
    ndg = spec.num_dir_groups
    npg = spec.num_pool_groups
    cpg = spec.cells_per_group
    ndg_flat = s_count * ndg
    s_ar = torch.arange(s_count, dtype=torch.int32, device=dev)

    # One sort by (slot-qualified group, cell-in-group, kind): both keys
    # pack into one int64 (sec = cig*2 + kind < 2^15).
    gaddr = torch.where(valid, slot * ndg + g_lin, ndg_flat)
    sec = cig * 2 + is_miss
    s_key, _ = torch.sort((gaddr.long() << 16) | sec.long())
    s_g = (s_key >> 16).to(torch.int32)
    s_sec = (s_key & 0xFFFF).to(torch.int32)
    s_valid = s_g < ndg_flat
    if spec.apply_groups <= 0:
        return _insert_records(bank, s_g, s_sec, s_valid, spec, hit_odds, miss_odds)
    from benchmark.reference.lio.ops.grouped_apply import apply_grouped_rows, build_group_tables

    group_cap = npg - 1  # the pool's last group per slot is K1's parking row
    rows_dir, starts, ends = build_group_tables(s_g, s_valid, int(spec.apply_groups))
    present = rows_dir >= 0  # absent steps trail (ranks are gapless)
    row_slot = torch.clamp(
        torch.div(torch.where(present, rows_dir, 0), ndg, rounding_mode="floor"), 0, s_count - 1)
    row_epoch = bank.epochs[row_slot.long()]
    cur_raw = bank.directory[torch.clamp(rows_dir, 0, ndg_flat - 1).long()]
    cur_pg, cur_ok = _decode_dir(cur_raw, row_epoch, spec)
    cur = torch.where(present & cur_ok, cur_pg, -1)
    needs = present & (cur < 0)
    needs_i = needs.to(torch.int32)
    incl = torch.cumsum(needs_i, 0, dtype=torch.int32)
    row_first = torch.ones_like(present)
    row_first[1:] = row_slot[1:] != row_slot[:-1]
    slot_base = torch.cummax(torch.where(row_first, incl - needs_i, 0), dim=0).values
    rank = (incl - needs_i) - slot_base
    # rows x S compares: cheap at the 16 slots of a batched step at B = 8
    counts_sel = torch.sum(
        torch.where(row_slot[:, None] == s_ar[None, :], bank.counts[None, :], 0),
        dim=1, dtype=torch.int32,
    )
    new_pg = counts_sel + rank
    alloc = needs & (new_pg < group_cap)
    pool_row = torch.where(cur >= 0, cur, torch.where(alloc, new_pg, -1))

    _scatter_(bank.directory, rows_dir, _encode_dir(new_pg, row_epoch, spec), alloc)
    _scatter_(bank.group_of_slot, row_slot * npg + new_pg, rows_dir - row_slot * ndg, alloc)
    counts = bank.counts + torch.sum(
        (row_slot[:, None] == s_ar[None, :]) & alloc[:, None], dim=0, dtype=torch.int32)
    dummy = s_count * npg - 1
    rows_pool = torch.where(pool_row >= 0, row_slot * npg + pool_row, dummy)
    # dropped (pool-full) and absent steps get empty ranges: they park
    ends = torch.where(pool_row >= 0, ends, starts)
    head = torch.ones_like(s_valid)
    head[1:] = s_g[1:] != s_g[:-1]
    heads_total = torch.sum(head & s_valid, dtype=torch.int32)
    kept = torch.sum(pool_row >= 0, dtype=torch.int32)
    dropped = add_to_first(bank.dropped, heads_total - kept)
    keys = (s_sec ^ 1).contiguous()  # kind bit flips to K1's is_hit convention
    apply_grouped_rows(
        bank.pool, rows_pool.contiguous(), starts.contiguous(), ends.contiguous(), keys,
        cells_per_group=cpg, hit_odds=hit_odds, miss_odds=miss_odds,
        fresh=alloc.to(torch.int32),
    )
    return bank._replace(counts=counts, dropped=dropped)


def _insert_records(bank: BrickBank, s_g, s_sec, s_valid, spec: BrickGridSpec, hit_odds: float,
                    miss_odds: float) -> BrickBank:
    """The per-record insert (`apply_groups == 0`) of records sorted by
    (slot-qualified group, cell, kind). Each group's head record claims the
    next pool group of its slot when its group has none (every pool group
    may be claimed: there is no parking row); a group that does not fit
    drops whole. The first record of each touched cell, a hit where there
    is one, decides the cell's one update. Integer state is the JAX
    package's bit for bit."""
    dev = s_g.device
    s_count = bank.counts.shape[0]
    ndg, npg, cpg = spec.num_dir_groups, spec.num_pool_groups, spec.cells_per_group
    ndg_flat = s_count * ndg
    s_ar = torch.arange(s_count, dtype=torch.int32, device=dev)
    s_cig, s_miss = s_sec >> 1, s_sec & 1
    s_slot = torch.clamp(torch.div(s_g, ndg, rounding_mode="floor"), 0, s_count - 1)
    group_head = torch.ones_like(s_valid)
    group_head[1:] = s_g[1:] != s_g[:-1]
    group_head &= s_valid
    s_epoch = bank.epochs[s_slot.long()]
    dec_pg, dec_ok = _decode_dir(bank.directory[torch.clamp(s_g, 0, ndg_flat - 1).long()], s_epoch, spec)
    cur_pg = torch.where(dec_ok, dec_pg, -1)
    # a group's records share its head's prefix count of claims, so every
    # record of a claiming group computes the head's new pool group
    needs = group_head & (cur_pg < 0)
    needs_i = needs.to(torch.int32)
    incl = torch.cumsum(needs_i, 0, dtype=torch.int32)
    slot_first = torch.ones_like(s_valid)
    slot_first[1:] = s_slot[1:] != s_slot[:-1]
    slot_base = torch.cummax(torch.where(slot_first, incl - needs_i, 0), dim=0).values
    counts_sel = torch.sum(
        torch.where(s_slot[:, None] == s_ar[None, :], bank.counts[None, :], 0), dim=1, dtype=torch.int32)
    new_pg = counts_sel + (incl - 1) - slot_base
    fits = new_pg < npg
    pg = torch.where(s_valid & (cur_pg >= 0), cur_pg,
                     torch.where(s_valid & (cur_pg < 0) & fits, new_pg, -1))
    alloc = needs & fits

    # one head per group and one new pool group per claim: distinct indices
    _scatter_(bank.directory, s_g, _encode_dir(new_pg, s_epoch, spec), alloc)
    _scatter_(bank.group_of_slot, s_slot * npg + new_pg, s_g - s_slot * ndg, alloc)
    counts = bank.counts + torch.sum(
        (s_slot[:, None] == s_ar[None, :]) & alloc[:, None], dim=0, dtype=torch.int32)

    # The JAX package writes the update at every record of a cell, all of
    # them the same value; writing it at the cell's first record alone
    # leaves the same pool with distinct indices.
    cell_head = torch.ones_like(s_valid)
    cell_head[1:] = (s_cig[1:] != s_cig[:-1]) | group_head[1:]
    write = cell_head & s_valid & (pg >= 0)
    addr = (s_slot.long() * spec.num_pool_cells + torch.clamp(pg, 0, npg - 1).long() * cpg
            + s_cig.long())
    current = bank.pool[torch.where(write, addr, 0)].to(torch.int32)
    updated = torch.where(s_miss == 1, pv.apply_odds(current, miss_odds),
                          pv.apply_odds(current, hit_odds))
    _scatter_(bank.pool, addr, updated.to(GRID_DTYPE), write)
    dropped = add_to_first(bank.dropped, torch.sum(needs & ~fits, dtype=torch.int32))
    return bank._replace(counts=counts, dropped=dropped)

"""Two-level brick probability grid, the HybridGrid analog (port of
dliom_tpu/mapping/brick_grid.py; reference mapping/3d/hybrid_grid.h).

  * directory: (2 * num_dir_groups,) int32 — Morton-coded brick group ->
    epoch-tagged pool group `(epoch << pg_bits) | pool_group`, or -1;
  * pool: (2 * num_pool_cells,) int16 — the allocated groups' cells.

Insertion takes the grouped path only: allocation and directory upkeep run
per touched group and the cell updates go through kernel K1
(ops/grouped_apply.py). The JAX package's per-record XLA fallback
(`apply_groups == 0`) is not ported and raises NotImplementedError.

Banks are updated in place: `reset_slot` writes the directory and
`_insert_brick_slots` the directory, `group_of_slot` and the pool of the
bank it is given, and both return a BrickBank that shares those tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dliom_tpu_torch.mapping import probability as pv
from dliom_tpu_torch.mapping.grid import GRID_DTYPE, smoothstep_trilinear
from dliom_tpu_torch.ops.grid_update import _trunc_div
from dliom_tpu_torch.ops.morton import part1by2

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
    dropped: torch.Tensor  # (1,) int32 running count of dropped groups
    epochs: torch.Tensor  # (2,) int32 per-slot spawn epoch


def make_brick_bank(spec: BrickGridSpec, device=None) -> BrickBank:
    i32 = dict(dtype=torch.int32, device=device)
    return BrickBank(
        directory=torch.full((2 * spec.num_dir_groups,), -1, **i32),
        pool=torch.zeros(2 * spec.num_pool_cells, dtype=GRID_DTYPE, device=device),
        counts=torch.zeros(2, **i32),
        group_of_slot=torch.zeros(2 * spec.num_pool_groups, **i32),
        dropped=torch.zeros(1, **i32),
        epochs=torch.zeros(2, **i32),
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
    in an unallocated group."""
    slot = torch.as_tensor(slot, dtype=torch.int32, device=cells.device)
    group, cig, ok = _split_cells(cells, spec)
    raw = bank.directory[(slot * spec.num_dir_groups + group).long()]
    pg, cur = _decode_dir(raw, _take(bank.epochs, slot), spec)
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
    Bumps the slot's epoch through epoch_mask (invalidating every entry of
    the old epoch) and clears `sweep_per_reset` rotating directory entries
    so a wrapped epoch never false-validates a stale entry. The directory
    is written in place; the pool's stale cells stay, unreachable until K1
    zero-fills a re-allocated group (`fresh`)."""
    if spec.apply_groups <= 0:
        raise NotImplementedError("brick grids without grouped apply are not ported")
    dev = bank.counts.device
    pending = torch.as_tensor(pending, device=dev)
    slot = torch.as_tensor(slot, dtype=torch.int32, device=dev)
    in_slot = torch.arange(2, dtype=torch.int32, device=dev) == slot
    counts = torch.where(in_slot & pending, 0, bank.counts)
    old_epoch = _take(bank.epochs, slot)
    epochs = torch.where(in_slot & pending, (old_epoch + 1) & spec.epoch_mask, bank.epochs)
    k = spec.sweep_per_reset
    start = old_epoch * k
    idx = (slot * spec.num_dir_groups
           + torch.remainder(start + torch.arange(k, dtype=torch.int32, device=dev),
                             spec.num_dir_groups)).long()
    bank.directory[idx] = torch.where(pending, -1, bank.directory[idx])
    return bank._replace(counts=counts, epochs=epochs)


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
    if spec.apply_groups <= 0:
        raise NotImplementedError(
            "brick insertion without grouped apply (the XLA fallback) is not ported")
    from dliom_tpu_torch.ops.grouped_apply import apply_grouped_rows, build_group_tables

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
    dropped = bank.dropped + (heads_total - kept)
    keys = (s_sec ^ 1).contiguous()  # kind bit flips to K1's is_hit convention
    apply_grouped_rows(
        bank.pool, rows_pool.contiguous(), starts.contiguous(), ends.contiguous(), keys,
        cells_per_group=cpg, hit_odds=hit_odds, miss_odds=miss_odds,
        fresh=alloc.to(torch.int32),
    )
    return bank._replace(counts=counts, dropped=dropped)

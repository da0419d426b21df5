"""K1's plain version, the grouped grid-update apply (a frozen copy of the
plain functions of dliom_tpu_torch/ops/grouped_apply.py): the reference runs
these on every device, never the CUDA kernel. `RECORD`, when a list, receives
the tables of every call, from which the benchmark counts the bytes the
kernel must move."""

from __future__ import annotations

import functools

import torch

from benchmark.reference.lio.mapping import probability as pv

_SENTINEL = 2**31 - 1

# Group size for dense banks; dense banks on the grouped path carry one
# extra group of padding at their end, the kernel's parking row.
DENSE_CELLS_PER_GROUP = 16384

# None, or a list that receives ("rows", starts, ends, keys, fresh, cells_per_group)
# of every apply and ("dense", keys, num_groups, cells_per_group) of every dense entry.
RECORD = None


def dense_bank_size(num_cells: int, num_slots: int, apply_groups: int) -> int:
    """Flat dense-bank length for `num_slots` slots; includes the padding
    group when the grouped-apply path is active."""
    n = num_slots * num_cells
    if apply_groups > 0:
        assert n % DENSE_CELLS_PER_GROUP == 0, (
            "extent^3 * slots must divide the group size for grouped apply")
        n += DENSE_CELLS_PER_GROUP
    return n


def cell_bits(cells_per_group: int) -> int:
    """Bits used for (cell_in_group << 1 | is_hit) in the packed key."""
    assert cells_per_group & (cells_per_group - 1) == 0
    return cells_per_group.bit_length()


def pack_keys(group, cell, is_hit, valid, cells_per_group: int) -> torch.Tensor:
    """Pack records into the sortable int32 key (group < 2**(31 - cell_bits))."""
    cb = cell_bits(cells_per_group)
    key = (group << cb) | (cell << 1) | is_hit.to(torch.int32)
    return torch.where(valid, key, _SENTINEL)


def build_group_tables(group_of: torch.Tensor, valid: torch.Tensor, num_groups: int):
    """From sorted per-record group ids, the per-step tables
    (rows, starts, ends), int32 (B,). rows is -1 for unused steps. Group
    ranks come from a cumsum of group heads, so the head of rank r is the
    first position where that cumsum reaches r+1: one binary search for all
    B+1 bounds. A group of rank >= B is dropped whole; bounds[B] is the
    first overflow head, so its records never leak into group B-1."""
    head = torch.ones_like(valid)
    head[1:] = group_of[1:] != group_of[:-1]
    vhead = head & valid
    n_valid = torch.sum(valid, dtype=torch.int32)
    c = torch.cumsum(vhead.to(torch.int32), 0, dtype=torch.int32)
    heads_total = c[-1]
    targets = torch.arange(1, num_groups + 2, dtype=torch.int32, device=group_of.device)
    bounds = torch.searchsorted(c, targets, side="left", out_int32=True)
    present = targets <= heads_total
    bounds = torch.where(present, bounds, n_valid)
    first = torch.clamp(bounds[:num_groups], 0, group_of.shape[0] - 1).long()
    rows = torch.where(present[:num_groups], group_of[first], -1)
    return rows, bounds[:num_groups], bounds[1:]


@functools.cache
def update_tables(hit_odds: float, miss_odds: float, device: torch.device):
    """int16 (32768,) hit and miss update tables on `device`. Made on the
    host with the plain float32 arithmetic, then copied, so their bits do
    not depend on the device. Never evicted: a captured CUDA graph reads
    them at their address on every replay."""
    hit = pv.compute_update_table(hit_odds).to(torch.int16).to(device)
    miss = pv.compute_update_table(miss_odds).to(torch.int16).to(device)
    return hit, miss


def apply_grouped_rows_plain(pool_flat, rows, starts, ends, cell_keys, *,
                             cells_per_group: int, hit_odds: float,
                             miss_odds: float, fresh=None) -> torch.Tensor:
    """Plain PyTorch version of K1; updates `pool_flat` in place and returns it."""
    num_steps = rows.shape[0]
    if fresh is None:
        fresh = torch.zeros(num_steps, dtype=torch.int32, device=rows.device)
    if RECORD is not None:
        RECORD.append(("rows", starts.clone(), ends.clone(), cell_keys.clone(), fresh.clone(),
                       cells_per_group))
    hit_t, miss_t = update_tables(float(hit_odds), float(miss_odds), pool_flat.device)
    lengths = torch.clamp(ends - starts, min=0).long()
    active = torch.nonzero((lengths > 0) | (fresh != 0)).squeeze(1)
    if active.numel() == 0:
        return pool_flat
    blocks_view = pool_flat.view(-1, cells_per_group)
    act_rows = rows[active].long()
    cur = blocks_view[act_rows]
    cur = torch.where((fresh[active] != 0)[:, None], torch.zeros_like(cur), cur)
    # record -> (active step, cell) via the concatenated ranges
    act_len = lengths[active]
    local = torch.repeat_interleave(torch.arange(active.numel(), device=rows.device), act_len)
    offsets = torch.cumsum(act_len, 0) - act_len
    pos = torch.arange(local.numel(), device=rows.device) - offsets[local]
    keys = cell_keys[starts[active].long()[local] + pos]
    cell = ((keys >> 1) & (cells_per_group - 1)).long()
    flat = local * cells_per_group + cell
    is_hit = (keys & 1) == 1
    hit_m = torch.zeros(cur.numel(), dtype=torch.bool, device=cur.device)
    miss_m = torch.zeros_like(hit_m)
    hit_m[flat[is_hit]] = True
    miss_m[flat[~is_hit]] = True
    hit_m = hit_m.view_as(cur)
    miss_m = miss_m.view_as(cur)
    idx = cur.long()
    new = torch.where(hit_m, hit_t[idx], torch.where(miss_m, miss_t[idx], cur))
    blocks_view[act_rows] = new
    return pool_flat


def _dense_tables(sorted_keys: torch.Tensor, num_groups: int, cells_per_group: int,
                  g_total: int, dummy_group: int):
    """K1's tables for a dense bank (group id == bank row): (rows, starts,
    ends, dropped). Steps beyond the touched groups park on `dummy_group`
    with empty ranges; `dropped` counts touched groups beyond capacity."""
    cb = cell_bits(cells_per_group)
    assert g_total << cb < 2**31, "packed key group id overflow"
    group_of = sorted_keys >> cb
    valid = sorted_keys != _SENTINEL
    rows, starts, ends = build_group_tables(group_of, valid, num_groups)
    head = torch.ones_like(valid)
    head[1:] = group_of[1:] != group_of[:-1]
    heads_total = torch.sum(head & valid, dtype=torch.int32)
    kept = torch.sum(rows >= 0, dtype=torch.int32)
    dropped = torch.clamp(heads_total - kept, min=0)
    rows = torch.where(rows >= 0, rows, dummy_group).to(torch.int32)
    return rows.contiguous(), starts.contiguous(), ends.contiguous(), dropped


def apply_grouped_updates_plain(pool_flat, sorted_keys, *, num_groups: int, cells_per_group: int,
                                hit_odds: float, miss_odds: float, dummy_group: int):
    """Plain PyTorch version of `apply_grouped_updates` (K1's plain version
    under the same tables); updates `pool_flat` in place."""
    if RECORD is not None:
        RECORD.append(("dense", sorted_keys.clone(), num_groups, cells_per_group))
    rows, starts, ends, dropped = _dense_tables(
        sorted_keys, num_groups, cells_per_group, pool_flat.shape[0] // cells_per_group,
        dummy_group)
    apply_grouped_rows_plain(pool_flat, rows, starts, ends, sorted_keys,
                             cells_per_group=cells_per_group, hit_odds=hit_odds,
                             miss_odds=miss_odds)
    return pool_flat, dropped




def apply_grouped_rows(pool_flat, rows, starts, ends, cell_keys, *, cells_per_group: int,
                       hit_odds: float, miss_odds: float, fresh=None) -> torch.Tensor:
    """K1's row entry, plain on every device, without the recording."""
    return apply_grouped_rows_plain(pool_flat, rows, starts, ends, cell_keys,
                                    cells_per_group=cells_per_group, hit_odds=hit_odds,
                                    miss_odds=miss_odds, fresh=fresh)


def apply_grouped_updates(pool_flat, sorted_keys, *, num_groups: int, cells_per_group: int,
                          hit_odds: float, miss_odds: float, dummy_group: int):
    """K1's dense entry, plain on every device."""
    return apply_grouped_updates_plain(pool_flat, sorted_keys, num_groups=num_groups,
                                       cells_per_group=cells_per_group, hit_odds=hit_odds,
                                       miss_odds=miss_odds, dummy_group=dummy_group)

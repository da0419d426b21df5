"""K1: the grouped grid-update apply, CUDA kernel and plain version, with
the host-side table helpers (port of dliom_tpu/ops/pallas_apply.py).

The grid bank is viewed as groups of `cells_per_group` int16 cells. One
insert's update records are sorted int32 keys `cell << 1 | is_hit` whose
per-group slices `keys[starts[i]:ends[i]]` update group `rows[i]`: a cell
with a hit record takes the hit-odds update, else a cell with a miss record
the miss-odds update, else it keeps its value ("update once, hits first",
range_data_inserter_3d.cc:78-92). `fresh[i] != 0` zero-fills the group
first. Steps with empty ranges and fresh == 0 change nothing, so unused and
dropped steps may all point at one parking row.

The odds updates are lookups into two 32768-entry int16 tables made by
`mapping/probability.py::compute_update_table` on the host, so the kernel
(csrc/grouped_apply.cu) and the plain version agree bit for bit with each
other and with the JAX package's float32 arithmetic.
"""

from __future__ import annotations

import functools

import torch

from dliom_tpu_torch import kernels
from dliom_tpu_torch.mapping import probability as pv

_SENTINEL = 2**31 - 1

# Group size for dense banks; dense banks on the grouped path carry one
# extra group of padding at their end, the kernel's parking row.
DENSE_CELLS_PER_GROUP = 16384

# Kernel launches through `apply_grouped_rows` (plain-version calls not counted).
LAUNCHES = 0


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


@functools.lru_cache(maxsize=8)
def update_tables(hit_odds: float, miss_odds: float, device: torch.device):
    """int16 (32768,) hit and miss update tables on `device`. Made on the
    host with the plain float32 arithmetic, then copied, so their bits do
    not depend on the device."""
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


def apply_grouped_rows(pool_flat, rows, starts, ends, cell_keys, *,
                       cells_per_group: int, hit_odds: float, miss_odds: float,
                       fresh=None) -> torch.Tensor:
    """Row-level entry (the caller owns group -> pool-row translation).
    Updates `pool_flat` in place and returns it. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if pool_flat.device.type == "cpu":
        return apply_grouped_rows_plain(
            pool_flat, rows, starts, ends, cell_keys, cells_per_group=cells_per_group,
            hit_odds=hit_odds, miss_odds=miss_odds, fresh=fresh)
    if pool_flat.device.type != "cuda":
        raise ValueError(f"apply_grouped_rows: unsupported device {pool_flat.device}")
    num_steps = rows.shape[0]
    if fresh is None:
        fresh = torch.zeros(num_steps, dtype=torch.int32, device=rows.device)
    if cells_per_group & (cells_per_group - 1) or cells_per_group < 256:
        raise ValueError(f"cells_per_group must be a power of two >= 256, got {cells_per_group}")
    if pool_flat.dtype != torch.int16 or not pool_flat.is_contiguous():
        raise ValueError("apply_grouped_rows: bank must be a contiguous int16 tensor")
    if pool_flat.numel() % cells_per_group or pool_flat.data_ptr() % 16:
        raise ValueError("apply_grouped_rows: bank must hold whole 16-byte aligned groups")
    for name, t, n in (("rows", rows, num_steps), ("starts", starts, num_steps),
                       ("ends", ends, num_steps), ("fresh", fresh, num_steps),
                       ("keys", cell_keys, cell_keys.shape[0])):
        if t.dtype != torch.int32 or t.device != pool_flat.device or t.dim() != 1 \
                or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"apply_grouped_rows: {name} must be a contiguous int32 "
                             f"({n},) tensor on {pool_flat.device}")
    hit_t, miss_t = update_tables(float(hit_odds), float(miss_odds), pool_flat.device)
    lib = kernels.library()
    stream = torch.cuda.current_stream(pool_flat.device).cuda_stream
    err = lib.dliom_grouped_apply(
        pool_flat.data_ptr(), rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        fresh.data_ptr(), cell_keys.data_ptr(), hit_t.data_ptr(), miss_t.data_ptr(),
        num_steps, cells_per_group, stream,
    )
    kernels.check(err, "grouped_apply")
    global LAUNCHES
    LAUNCHES += 1
    return pool_flat

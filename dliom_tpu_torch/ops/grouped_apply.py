"""K1: the grouped grid-update apply, CUDA kernel and plain version, with
the step-table helpers (port of dliom_tpu/ops/pallas_apply.py). On the
card the dense entry is one kernel over the sorted keys; its plain version
builds the step tables (`_dense_tables`) and applies them.

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

import contextlib
import functools
import threading

import torch

from dliom_tpu_torch import kernels
from dliom_tpu_torch.common import launches
from dliom_tpu_torch.mapping import probability as pv

_SENTINEL = 2**31 - 1

# Group size for dense banks; dense banks on the grouped path carry one
# extra group of padding at their end, the kernel's parking row.
DENSE_CELLS_PER_GROUP = 16384

# K1 launches through `apply_grouped_rows` and `apply_grouped_updates`
# (plain-version calls not counted).
LAUNCHES = 0
# Of those, launches through the dense-bank entry `apply_grouped_updates`.
DENSE_LAUNCHES = 0
# The dense kernel's look-back scratch, per (device, stream), for eager calls.
_LOOKBACK: dict = {}
# The scratch owner of the calls this thread makes (`lookback_owner`).
_OWNER = threading.local()


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


def _check_bank(pool_flat: torch.Tensor, cells_per_group: int, what: str) -> None:
    """Raise unless `pool_flat` is a bank the kernel takes."""
    if cells_per_group & (cells_per_group - 1) or cells_per_group < 256:
        raise ValueError(f"cells_per_group must be a power of two >= 256, got {cells_per_group}")
    if pool_flat.dtype != torch.int16 or not pool_flat.is_contiguous():
        raise ValueError(f"{what}: bank must be a contiguous int16 tensor")
    if pool_flat.numel() % cells_per_group or pool_flat.data_ptr() % 16:
        raise ValueError(f"{what}: bank must hold whole 16-byte aligned groups")


def _check_int32(what: str, name: str, t: torch.Tensor, n: int, device: torch.device) -> None:
    if t.dtype != torch.int32 or t.device != device or t.dim() != 1 \
            or t.shape[0] != n or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous int32 ({n},) tensor on {device}")


def apply_grouped_rows(pool_flat, rows, starts, ends, cell_keys, *,
                       cells_per_group: int, hit_odds: float, miss_odds: float,
                       fresh=None) -> torch.Tensor:
    """Row-level entry (the caller owns group -> pool-row translation).
    Updates `pool_flat` in place and returns it. CPU tensors take the plain
    version; CUDA tensors launch the kernel. Steps with records, or fresh,
    must own distinct rows. The kernel (one CTA per step) relies on each
    cell's records being contiguous within a step's range, as the brick
    insert (`mapping/brick_grid.py::_insert_brick_slots`, records sorted by
    group, cell and kind) gives them; the plain version does not."""
    if pool_flat.device.type == "cpu":
        return apply_grouped_rows_plain(
            pool_flat, rows, starts, ends, cell_keys, cells_per_group=cells_per_group,
            hit_odds=hit_odds, miss_odds=miss_odds, fresh=fresh)
    if pool_flat.device.type != "cuda":
        raise ValueError(f"apply_grouped_rows: unsupported device {pool_flat.device}")
    num_steps = rows.shape[0]
    if fresh is None:
        fresh = torch.zeros(num_steps, dtype=torch.int32, device=rows.device)
    _check_bank(pool_flat, cells_per_group, "apply_grouped_rows")
    for name, t, n in (("rows", rows, num_steps), ("starts", starts, num_steps),
                       ("ends", ends, num_steps), ("fresh", fresh, num_steps),
                       ("keys", cell_keys, cell_keys.shape[0])):
        _check_int32("apply_grouped_rows", name, t, n, pool_flat.device)
    hit_t, miss_t = update_tables(float(hit_odds), float(miss_odds), pool_flat.device)
    lib = kernels.library()
    with torch.cuda.device(pool_flat.device):  # the launch goes to the bank's card
        stream = torch.cuda.current_stream(pool_flat.device).cuda_stream
        err = lib.dliom_grouped_apply(
            pool_flat.data_ptr(), rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
            fresh.data_ptr(), cell_keys.data_ptr(), hit_t.data_ptr(), miss_t.data_ptr(),
            num_steps, cells_per_group, stream,
        )
    kernels.check(err, "grouped_apply")
    launches.count(__name__, "LAUNCHES")
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
    rows, starts, ends, dropped = _dense_tables(
        sorted_keys, num_groups, cells_per_group, pool_flat.shape[0] // cells_per_group,
        dummy_group)
    apply_grouped_rows_plain(pool_flat, rows, starts, ends, sorted_keys,
                             cells_per_group=cells_per_group, hit_odds=hit_odds,
                             miss_odds=miss_odds)
    return pool_flat, dropped


class LookbackScratch:
    """Look-back scratch that one owner (a CUDA graph) keeps for the dense
    calls it makes, eager and captured: a captured call's scratch must be
    its graph's, allocated before the capture, or an eager call on the
    capture stream could share it with a replay running on another. It
    must live as long as any graph that captured a call with it."""

    def __init__(self):
        self.buf = None


@contextlib.contextmanager
def lookback_owner(scratch: LookbackScratch):
    """Dense calls this thread makes inside take their look-back scratch
    from `scratch` (grown outside a capture only)."""
    prev = getattr(_OWNER, "scratch", None)
    _OWNER.scratch = scratch
    try:
        yield scratch
    finally:
        _OWNER.scratch = prev


def _lookback_scratch(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """The dense kernel's look-back scratch, at least `tiles` status words:
    zeroed once when allocated (or grown), then left ready for the next call
    by each call's last tile. Under `lookback_owner` it is the owner's;
    else the one kept for `stream` on `device`. Calls on one stream run one
    after another, so they share it; each stream has its own. A call being
    captured takes its owner's scratch, which must hold `tiles` already."""
    need = 4 + 2 * tiles  # int32: ticket, finished, epoch, pad; 8 bytes a tile
    owner = getattr(_OWNER, "scratch", None)
    capturing = torch.cuda.is_current_stream_capturing()
    if capturing and (owner is None or owner.buf is None or owner.buf.numel() < need):
        raise RuntimeError("apply_grouped_updates captured without look-back scratch its graph "
                           "owns: run the call once under lookback_owner(...) before the capture")
    if owner is not None:
        if owner.buf is None or owner.buf.numel() < need:
            owner.buf = torch.zeros(need, dtype=torch.int32, device=device)
        return owner.buf
    buf = _LOOKBACK.get((device, stream))
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.int32, device=device)
        _LOOKBACK[(device, stream)] = buf
    return buf


def apply_grouped_updates(pool_flat, sorted_keys, *, num_groups: int, cells_per_group: int,
                          hit_odds: float, miss_odds: float, dummy_group: int):
    """K1's dense-bank entry (pallas_apply.py::apply_grouped_updates): apply
    one insert's sorted packed keys `(group << cell_bits) | (cell << 1) |
    is_hit` (sentinel-padded) to the bank, group id == bank row, in place.
    `dummy_group` is a group no record touches (the bank's padding group);
    the plain version parks unused steps there and leaves it unchanged.
    Returns (bank, dropped): `dropped` () int32 counts touched groups beyond
    `num_groups`, lost whole. CPU tensors take the plain version. On CUDA
    tensors one kernel launch applies the keys and counts `dropped` (the
    group ranks come from a look-back across tiles of keys, with scratch
    kept per stream or by a `lookback_owner`); the kernel relies on the keys being sorted, so each
    cell's records are contiguous (`ops/grid_update.py::_insert_slots`
    sorts them)."""
    if pool_flat.device.type == "cpu":
        return apply_grouped_updates_plain(
            pool_flat, sorted_keys, num_groups=num_groups, cells_per_group=cells_per_group,
            hit_odds=hit_odds, miss_odds=miss_odds, dummy_group=dummy_group)
    if pool_flat.device.type != "cuda":
        raise ValueError(f"apply_grouped_updates: unsupported device {pool_flat.device}")
    _check_bank(pool_flat, cells_per_group, "apply_grouped_updates")
    _check_int32("apply_grouped_updates", "sorted_keys", sorted_keys, sorted_keys.shape[0],
                 pool_flat.device)
    cb = cell_bits(cells_per_group)
    g_total = pool_flat.shape[0] // cells_per_group
    assert g_total << cb < 2**31, "packed key group id overflow"
    if not 0 <= dummy_group < g_total or num_groups < 0:
        raise ValueError(f"apply_grouped_updates: dummy_group {dummy_group} outside the bank's "
                         f"{g_total} groups, or num_groups {num_groups} < 0")
    if sorted_keys.shape[0] >= 2**30:
        raise ValueError("apply_grouped_updates: at most 2**30 - 1 keys")
    hit_t, miss_t = update_tables(float(hit_odds), float(miss_odds), pool_flat.device)
    lib = kernels.library()
    tiles = max(1, -(-sorted_keys.shape[0] // lib.dliom_dense_tile_keys()))
    with torch.cuda.device(pool_flat.device):  # the launch goes to the bank's card
        stream = torch.cuda.current_stream(pool_flat.device).cuda_stream
        lookback = _lookback_scratch(pool_flat.device, stream, tiles)
        dropped = torch.empty((), dtype=torch.int32, device=pool_flat.device)
        err = lib.dliom_grouped_apply_dense(
            pool_flat.data_ptr(), sorted_keys.data_ptr(), sorted_keys.shape[0], hit_t.data_ptr(),
            miss_t.data_ptr(), lookback.data_ptr(), tiles, dropped.data_ptr(), num_groups, cb, stream,
        )
    kernels.check(err, "grouped_apply_dense")
    launches.count(__name__, "LAUNCHES", "DENSE_LAUNCHES")
    return pool_flat, dropped

"""Range-data insertion into dense submap grids (port of
dliom_tpu/ops/grid_update.py; reference RangeDataInserter3D,
range_data_inserter_3d.cc).

Every hit cell gets one hit-odds update; along each ray the last
`num_free_space_voxels` equidistant samples get one miss-odds update;
within one insert each cell updates at most once, hits first. All records
of one insert are sorted by `cell * 2 + is_miss`, so the first record of a
cell decides its update kind; every record of the cell then writes the
same updated value.

Banks are flat int16 tensors updated in place. With `spec.apply_groups > 0`
the records go through K1's dense entry (`ops/grouped_apply.py::
apply_grouped_updates`) and the bank carries one padding group at its end.
The odds updates are lookups into the update tables of
`mapping/probability.py`, equal to the JAX package's float32 arithmetic.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.lio.mapping.grid import GridSpec, cell_index, linear_index


def _trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C++-style integer division truncating toward zero (b > 0). Torch's
    `//` floors, so the remainder corrects negative quotients."""
    q = torch.div(a, b, rounding_mode="floor")
    r = a - q * b
    return q + ((r != 0) & (a < 0)).to(a.dtype)


def _odds(hit_probability: float, miss_probability: float):
    return hit_probability / (1.0 - hit_probability), miss_probability / (1.0 - miss_probability)


def _apply_sorted_records(flat: torch.Tensor, lin: torch.Tensor, is_miss: torch.Tensor,
                          num_valid_cells: int, hit_odds: float, miss_odds: float) -> None:
    """Update-once, hits first, over records `lin` (invalid ones equal
    `num_valid_cells`), in place. One sort of the packed key; each record
    writes its cell's head decision, dropped records write nothing."""
    from benchmark.reference.lio.mapping.brick_grid import _scatter_
    from benchmark.reference.lio.ops.grouped_apply import update_tables

    if 2 * (num_valid_cells + 1) < 2**31:
        s_key, _ = torch.sort(lin * 2 + is_miss)
        s_lin = s_key >> 1
        s_miss = s_key & 1
    else:
        s_key, _ = torch.sort((lin.long() << 1) | is_miss.long())
        s_lin = (s_key >> 1).to(torch.int32)
        s_miss = (s_key & 1).to(torch.int32)
    m = s_lin.shape[0]
    first = torch.ones(m, dtype=torch.bool, device=flat.device)
    first[1:] = s_lin[1:] != s_lin[:-1]
    ar = torch.arange(m, dtype=torch.int32, device=flat.device)
    head_pos = torch.cummax(torch.where(first, ar, 0), dim=0).values
    head_is_miss = s_miss[head_pos.long()]
    current = flat[torch.clamp(s_lin, 0, num_valid_cells - 1).long()].long()
    hit_t, miss_t = update_tables(float(hit_odds), float(miss_odds), flat.device)
    updated = torch.where(head_is_miss == 1, miss_t[current], hit_t[current])
    _scatter_(flat, s_lin, updated, s_lin < num_valid_cells)


def insert_range_data(
    values: torch.Tensor,
    origin: torch.Tensor,
    hits: torch.Tensor,
    hits_mask: torch.Tensor,
    *,
    spec: GridSpec,
    hit_probability: float = 0.55,
    miss_probability: float = 0.49,
    num_free_space_voxels: int = 2,
    slot=0,
) -> torch.Tensor:
    """Insert one range-data batch into slot `slot` of the flat bank
    `values` (in place); returns `values`."""
    base = torch.as_tensor(slot, dtype=torch.int32, device=values.device) * spec.num_cells
    hit_odds, miss_odds = _odds(hit_probability, miss_probability)
    k = int(num_free_space_voxels)
    res = spec.resolution
    hit_cells = cell_index(hits, res)
    origin_cell = cell_index(origin, res)
    delta = hit_cells - origin_cell
    num_samples = torch.amax(torch.abs(delta), dim=-1)
    hit_lin, hit_ok = linear_index(hit_cells, spec)
    lins = [torch.where(hits_mask & hit_ok, hit_lin, spec.num_cells)]
    misses = [torch.zeros_like(hit_lin)]
    n = num_samples[:, None]
    safe_n = torch.clamp(n, min=1)
    for j in range(1, k + 1):
        lin, ok = linear_index(origin_cell + _trunc_div(delta * (n - j), safe_n), spec)
        lins.append(torch.where(hits_mask & ok & (num_samples >= j), lin, spec.num_cells))
        misses.append(torch.ones_like(lin))
    lin = torch.cat(lins)
    # the slot offset shifts valid records only; invalid ones drop
    glin = torch.where(lin < spec.num_cells, lin + base, values.shape[0])
    _apply_sorted_records(values, glin, torch.cat(misses), values.shape[0], hit_odds, miss_odds)
    return values


def _insert_slots(
    values: torch.Tensor,  # (S * num_cells [+ 16384],) flat bank, slot k at k*num_cells
    origins: torch.Tensor,  # (S, 3) per-slot origin in the slot's frame
    hits: torch.Tensor,  # (S, N, 3) per-slot hit points in the slot's frame
    masks: torch.Tensor,  # (S, N)
    *,
    spec: GridSpec,
    hit_probability: float,
    miss_probability: float,
    num_free_space_voxels: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one scan batch into S slots with one sort over the combined
    records (S = 2: the two active submaps). Updates `values` in place.
    Returns (values, dropped): `dropped` is the () int32 count of touched
    groups lost to the grouped-apply capacity (0 on the sort/scatter path)."""
    hit_odds, miss_odds = _odds(hit_probability, miss_probability)
    k = int(num_free_space_voxels)
    res = spec.resolution
    s_count = hits.shape[0]
    num_flat = s_count * spec.num_cells
    dev = values.device
    use_groups = spec.apply_groups > 0
    if use_groups:
        from benchmark.reference.lio.ops.grouped_apply import DENSE_CELLS_PER_GROUP

        assert num_flat % DENSE_CELLS_PER_GROUP == 0, (
            "extent^3 not group-divisible; disable apply_groups")
        assert values.shape[0] == num_flat + DENSE_CELLS_PER_GROUP, (
            "grouped-apply banks carry one padding group (dense_bank_size)")
    else:
        assert values.shape[0] == num_flat, (values.shape, s_count, spec.num_cells)
    assert num_flat < 2**31 - 1, "flat bank exceeds int32 indexing"

    hit_cells = cell_index(hits, res)  # (S, N, 3)
    origin_cell = cell_index(origins, res)[:, None, :]  # (S, 1, 3)
    delta = hit_cells - origin_cell
    num_samples = torch.amax(torch.abs(delta), dim=-1)  # (S, N)
    base = (torch.arange(s_count, dtype=torch.int32, device=dev) * spec.num_cells)[:, None]

    hit_lin, hit_ok = linear_index(hit_cells, spec)
    lins = [torch.where(masks & hit_ok, base + hit_lin, num_flat).reshape(-1)]
    count = hits.shape[0] * hits.shape[1]
    misses = [torch.zeros(count, dtype=torch.int32, device=dev)]
    n = num_samples[..., None]
    safe_n = torch.clamp(n, min=1)
    for j in range(1, k + 1):
        lin, ok = linear_index(origin_cell + _trunc_div(delta * (n - j), safe_n), spec)
        valid = masks & ok & (num_samples >= j)
        lins.append(torch.where(valid, base + lin, num_flat).reshape(-1))
        misses.append(torch.ones(count, dtype=torch.int32, device=dev))
    all_lin = torch.cat(lins)
    is_miss = torch.cat(misses)

    if use_groups:
        from benchmark.reference.lio.ops.grouped_apply import (
            DENSE_CELLS_PER_GROUP,
            apply_grouped_updates,
            pack_keys,
        )

        valid = all_lin < num_flat
        group = torch.div(all_lin, DENSE_CELLS_PER_GROUP, rounding_mode="floor")
        cell = all_lin - group * DENSE_CELLS_PER_GROUP
        # equal packed records are interchangeable: one unstable sort
        keys, _ = torch.sort(pack_keys(group, cell, 1 - is_miss, valid, DENSE_CELLS_PER_GROUP))
        return apply_grouped_updates(
            values, keys, num_groups=int(spec.apply_groups),
            cells_per_group=DENSE_CELLS_PER_GROUP, hit_odds=hit_odds, miss_odds=miss_odds,
            dummy_group=values.shape[0] // DENSE_CELLS_PER_GROUP - 1,
        )

    _apply_sorted_records(values, all_lin, is_miss, num_flat, hit_odds, miss_odds)
    return values, torch.zeros((), dtype=torch.int32, device=dev)


def insert_range_data_dual(
    values: torch.Tensor,  # (2 * num_cells [+ 16384],) flat bank
    origins: torch.Tensor,  # (2, 3)
    hits: torch.Tensor,  # (2, N, 3)
    masks: torch.Tensor,  # (2, N)
    *,
    spec: GridSpec,
    hit_probability: float = 0.55,
    miss_probability: float = 0.49,
    num_free_space_voxels: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one scan into both submap slots (see _insert_slots); the JAX
    package's custom batching rule has no counterpart here."""
    return _insert_slots(
        values, origins, hits, masks, spec=spec, hit_probability=float(hit_probability),
        miss_probability=float(miss_probability), num_free_space_voxels=int(num_free_space_voxels),
    )

"""One lane of the program's batched LIO state as a single sequence's
state, for the reference to step alone: a copy of the layout that
dliom_tpu_torch/parallel/batch.py documents (every per-sequence leaf has a
leading lane axis; the grid banks are flat and shared, lane b's two
active submaps in slots 2b and 2b + 1; the drop counters are (B,) with
the aggregate in element 0). It reads the program's state by field name
and copies what it takes."""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

_BANKS = ("high_values", "low_values", "high_brick", "low_brick", "dense_dropped")


def _dense(values: torch.Tensor, spec, b: int, lanes: int) -> torch.Tensor:
    if values.numel() == 0:
        return values.clone()
    return torch.cat([values[2 * b * spec.num_cells:(2 * b + 2) * spec.num_cells],
                      values[2 * lanes * spec.num_cells:]])


def _bricks(bank, spec, b: int):
    if bank is None:
        return None

    def two(x, per_slot):
        return x[2 * b * per_slot:(2 * b + 2) * per_slot].clone()

    return bank._replace(directory=two(bank.directory, spec.num_dir_groups),
                         pool=two(bank.pool, spec.num_pool_cells), counts=two(bank.counts, 1),
                         group_of_slot=two(bank.group_of_slot, spec.num_pool_groups),
                         dropped=torch.zeros_like(bank.dropped[:1]), epochs=two(bank.epochs, 1))


def lane_state(state, b: int, specs: dict):
    """Lane b of a batched LIO state (the program's types), with copies of
    its banks. `specs` are the single sequence's grid sizes
    (`benchmark.reference.step.spec_numbers`)."""
    sm = state.frontend.submaps
    lanes = sm.lane.shape[0]
    per_lane = sm._replace(**{f: None for f in _BANKS})
    one = tree_map(lambda x: None if x is None else x[b].clone(),
                   state._replace(frontend=state.frontend._replace(submaps=per_lane)))
    sub = one.frontend.submaps._replace(
        lane=torch.zeros_like(sm.lane[0]),
        high_values=_dense(sm.high_values, specs["hi"], b, lanes),
        low_values=_dense(sm.low_values, specs["lo"], b, lanes),
        high_brick=_bricks(sm.high_brick, specs["hi_brick"], b),
        low_brick=_bricks(sm.low_brick, specs["lo_brick"], b),
        dense_dropped=torch.zeros_like(sm.dense_dropped[:1]))
    return one._replace(frontend=one.frontend._replace(submaps=sub))


def drops(state) -> dict:
    """The drop gauges of a (batched) state by grid (aggregated in element 0),
    with each brick pool's fullest slot: allocated groups of its groups."""
    sm = state.frontend.submaps
    out = {}
    for name in ("high_brick", "low_brick"):
        bank = getattr(sm, name)
        if bank is not None:
            out[name] = int(bank.dropped[0])
            per_slot = bank.group_of_slot.shape[0] // bank.counts.shape[0]
            out[name + "_fullest"] = f"{int(bank.counts.max())}/{per_slot}"
    if sm.dense_dropped is not None:
        out["dense"] = int(sm.dense_dropped[0])
    return out

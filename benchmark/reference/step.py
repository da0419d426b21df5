"""The reference's side of a check: the frozen plain LIO step (`lio/`) run
from a state the program handed over, and the arithmetic that compares
the two.

The reference follows the program step by step from the program's own
pre-step state, since two free-running chains of float32 states part by
rounding within a few scans (the window Gauss-Newton's normal equations
have condition numbers near 3e5). What it compares is one step: the pose,
velocity and biases it yields, and the map it leaves, decoded cell by cell.
"""

from __future__ import annotations

import contextlib
import importlib
import pkgutil
from typing import Dict

import torch

from benchmark.reference import lio as _lio
from benchmark.reference.lio.common.config import load_config
from benchmark.reference.lio.frontend.lio import lio_step
from benchmark.reference.lio.mapping.brick_grid import BrickGridSpec
from benchmark.reference.lio.mapping.submap import brick_spec, brick_spec_low, grid_specs


def config(spec: dict):
    """The configuration's trajectory builder, built by the reference's own
    copy of the configuration code."""
    return load_config(spec["preset"], spec.get("overrides") or {}).trajectory_builder


def _registry() -> Dict[str, type]:
    out = {}
    for mod in pkgutil.walk_packages(_lio.__path__, _lio.__name__ + "."):
        m = importlib.import_module(mod.name)
        for name, obj in vars(m).items():
            if isinstance(obj, type) and issubclass(obj, tuple) and hasattr(obj, "_fields"):
                out.setdefault(name, obj)
    return out


_CLASSES: Dict[str, type] = {}


def convert(obj):
    """A copy of a state or result tree as the reference's own types, field
    by field by name (a field the program added is left out; one it lacks
    raises). Tensors are cloned."""
    if not _CLASSES:
        _CLASSES.update(_registry())
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = _CLASSES[type(obj).__name__]
        return cls(**{f: convert(getattr(obj, f)) for f in cls._fields})
    if isinstance(obj, (list, tuple)):
        return type(obj)(convert(x) for x in obj)
    return obj


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products exact (TF32 off), or in TF32 for the control; the
    CUDA linear algebra through cuSOLVER, as the program's captures take it."""
    cuda = torch.backends.cuda
    prev = (cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    lib = cuda.preferred_linalg_library() if torch.cuda.is_available() else None
    cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    if lib is not None:
        cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[0], prev[1]
        torch.set_float32_matmul_precision(prev[2])
        if lib is not None:
            cuda.preferred_linalg_library(lib)


def step(cfg, state, inp, tf32: bool = False):
    """One reference LIO step on the reference's state (updated in place)."""
    with precision(tf32):
        return lio_step(state, inp, cfg)


# ----- the map, decoded cell by cell -----

_SHIFT = 34  # key = (tag << _SHIFT) | cell index within the tagged grid and slot


def _dense_cells(values: torch.Tensor, tag: int):
    idx = torch.nonzero(values).squeeze(1)
    return (tag << _SHIFT) | idx, values[idx]


def _brick_cells(bank, spec: BrickGridSpec, tag: int):
    keys, vals = [], []
    ndg, cpg, npc = spec.num_dir_groups, spec.cells_per_group, spec.num_pool_cells
    cells = torch.arange(cpg, device=bank.pool.device)
    for s in range(bank.epochs.shape[0]):
        raw = bank.directory[s * ndg:(s + 1) * ndg].long()
        ok = (raw >= 0) & ((raw >> spec.pg_bits) == bank.epochs[s].long())
        d = torch.nonzero(ok).squeeze(1)
        pg = raw[d] & ((1 << spec.pg_bits) - 1)
        v = bank.pool[(s * npc + pg[:, None] * cpg + cells[None]).reshape(-1)]
        k = ((tag + s) << _SHIFT) | (d[:, None] * cpg + cells[None]).reshape(-1)
        nz = v != 0
        keys.append(k[nz])
        vals.append(v[nz])
    return torch.cat(keys), torch.cat(vals)


_BOOKKEEPING = ("num_range_data", "num_created", "pending_spawn", "dense_dropped")
_BANK_BOOKKEEPING = ("counts", "dropped", "epochs")


def cell_map(state, cfg):
    """(keys, values) of every non-zero cell of both active submaps' grids,
    keyed by grid, slot and the cell's place in the grid (not in the pool,
    whose layout follows the order of allocation), plus the integer
    bookkeeping of the submaps, the scan count and the motion filter, and
    the drop gauges."""
    sm = state.frontend.submaps
    smc = cfg.submaps
    parts = []
    if sm.high_brick is not None:
        parts.append(_brick_cells(sm.high_brick, brick_spec(smc), 0))
    if sm.high_values is not None and sm.high_values.numel():
        parts.append(_dense_cells(sm.high_values, 2))
    if sm.low_brick is not None:
        parts.append(_brick_cells(sm.low_brick, brick_spec_low(smc), 4))
    if sm.low_values is not None and sm.low_values.numel():
        parts.append(_dense_cells(sm.low_values, 6))
    fe = state.frontend
    book = [getattr(sm, f) for f in _BOOKKEEPING] + [
        fe.scan_index, fe.motion_filter.num_total, fe.motion_filter.num_different]
    for bank in (sm.high_brick, sm.low_brick):
        book += [getattr(bank, f) for f in _BANK_BOOKKEEPING] if bank is not None else []
    book = torch.cat([b.reshape(-1).long() for b in book if b is not None])
    dev = book.device
    parts.append(((8 << _SHIFT) | torch.arange(book.numel(), device=dev), book + 1))
    keys = torch.cat([k.long() for k, _ in parts])
    vals = torch.cat([v.long() for _, v in parts])
    return keys, vals


def mismatched_cells(a, b) -> int:
    """Cells (keys) whose value differs between two cell maps, a cell
    present in one only counting once."""
    (ka, va), (kb, vb) = a, b
    pa, pb = ka * (1 << 20) + (va & 0xFFFFF), kb * (1 << 20) + (vb & 0xFFFFF)
    only = torch.cat([ka[~torch.isin(pa, pb)], kb[~torch.isin(pb, pa)]])
    return int(torch.unique(only).numel())


def nav_gaps(prog: torch.Tensor, ref: torch.Tensor):
    """(translation, rotation, velocity, bias) gaps of two packed rows
    (`pack`, float64); the rotation gap is the angle of the relative
    quaternion."""
    a, b = prog[:4], ref[:4]
    w = a[0] * b[0] + torch.sum(a[1:] * b[1:])
    v = a[0] * b[1:] - b[0] * a[1:] - torch.linalg.cross(a[1:], b[1:])
    rot = 2.0 * torch.atan2(torch.linalg.vector_norm(v), torch.abs(w))
    return (float(torch.linalg.vector_norm(prog[4:7] - ref[4:7])), float(rot),
            float(torch.linalg.vector_norm(prog[7:10] - ref[7:10])),
            float(torch.max(torch.abs(prog[10:16] - ref[10:16]))))


def _gap(x: torch.Tensor, y: torch.Tensor) -> float:
    """The largest absolute difference, equal values (infinities too) 0."""
    d = torch.where(x == y, 0.0, torch.abs(x.double() - y.double()))
    return float(torch.max(torch.nan_to_num(d, nan=float("inf"))))


def _scale(y: torch.Tensor) -> float:
    finite = y[torch.isfinite(y)]
    return float(torch.max(torch.abs(finite))) if finite.numel() else 0.0


def leaf_gaps(prog_state, ref_state, prog_answer=None, ref_answer=None) -> Dict[str, float]:
    """Per float leaf of two states (the program's and the reference's,
    matched by field name), and of the answers read back where given: the
    largest absolute difference over the larger of the reference leaf's
    largest magnitude and the median leaf's."""
    from torch.utils._pytree import tree_flatten_with_path

    a = dict(tree_flatten_with_path(convert(prog_state))[0])
    pairs = [(".".join(str(getattr(k, "name", k)) for k in path), a[path], y)
             for path, y in tree_flatten_with_path(ref_state)[0]
             if y is not None and y.is_floating_point() and y.numel()]
    if prog_answer is not None:
        pairs.append(("answer", prog_answer, ref_answer))
    scale = {n: _scale(y) for n, _, y in pairs}
    median = float(torch.median(torch.tensor(list(scale.values()), dtype=torch.float64))) if scale else 0.0
    return {n: _gap(x, y) / max(scale[n], median, 1e-30) for n, x, y in pairs}


def pack_state(state) -> torch.Tensor:
    """A LIO state's navigation state and biases, laid out as `pack`'s
    first 16 values."""
    nav = state.nav
    return torch.cat([nav.rotation, nav.position, nav.velocity, state.ba, state.bg], -1)


PACKED = 17  # q(4), t(3), v(3), ba(3), bg(3), points kept by the voxel filter


def pack(result) -> torch.Tensor:
    """A LIO result's pose, velocity and biases, and the points its voxel
    filter kept, as (..., PACKED) float32."""
    pose = result.scan.local_pose
    hits = result.scan.num_hits.to(torch.float32)[..., None]
    return torch.cat([pose.rotation, pose.translation, result.velocity, result.ba, result.bg, hits], -1)


def spec_numbers(cfg) -> dict:
    """The grid sizes lane extraction needs (benchmark/reference/lanes.py)."""
    smc = cfg.submaps
    hi, lo = grid_specs(smc)
    return {"hi": hi, "lo": lo, "hi_brick": brick_spec(smc), "lo_brick": brick_spec_low(smc)}

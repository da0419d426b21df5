"""State carried between the JAX package and the port.

The JAX package's states are NamedTuple trees; a caller turns one into
numpy with `jax.tree.map(np.asarray, tree)` and hands it here. Fields map by
name onto the port's NamedTuples of the same class names and field names,
so both packages can start from one `LioState` and be compared field by
field after each step. This module imports no jax.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dliom_tpu_torch.frontend.lio import LioResult, LioScanInput, LioState
from dliom_tpu_torch.frontend.local_trajectory_builder import FrontendState, ScanResult
from dliom_tpu_torch.imu.preintegration import NavState, Preintegrated
from dliom_tpu_torch.imu.window_optimizer import WindowState
from dliom_tpu_torch.mapping.brick_grid import BrickBank
from dliom_tpu_torch.mapping.motion_filter import MotionFilterState
from dliom_tpu_torch.mapping.submap import ActiveSubmaps
from dliom_tpu_torch.transform.rigid import Rigid3

_TYPES = {
    cls.__name__: cls
    for cls in (LioState, LioScanInput, LioResult, FrontendState, ScanResult, NavState,
                Preintegrated, WindowState, BrickBank, MotionFilterState, ActiveSubmaps, Rigid3)
}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree: Any, device) -> Any:
    """numpy NamedTuple tree -> the port's NamedTuple tree of tensors."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        name = type(tree).__name__
        if name not in _TYPES:
            raise TypeError(f"no port counterpart for {name}")
        cls = _TYPES[name]
        if set(cls._fields) != set(tree._fields):
            raise TypeError(f"{name}: fields differ: {cls._fields} vs {tree._fields}")
        return cls(**{f: to_torch(getattr(tree, f), device) for f in cls._fields})
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree: Any) -> Any:
    """The port's NamedTuple tree of tensors -> the same tree of numpy arrays."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(x) for x in tree))
    return tree.detach().cpu().numpy()


def lio_state_from_numpy(tree, device) -> LioState:
    return to_torch(tree, device)


def lio_state_to_numpy(state: LioState) -> LioState:
    return to_numpy(state)


def lio_scan_input_from_numpy(tree, device) -> LioScanInput:
    return to_torch(tree, device)

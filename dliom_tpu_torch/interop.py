"""State carried between the JAX package and the port.

The JAX package's states are NamedTuple trees; a caller turns one into
numpy with `jax.tree.map(np.asarray, tree)` and hands it here. Fields map by
name onto the port's NamedTuples of the same class names and field names,
so both packages can start from one `LioState` (or `ActiveSubmaps`,
`CompressedGrid`, `Pyramid`, `PoseGraphData`, `NdtField`,
`AlignmentInput`, `InitResult`) and be compared field by field. The pose
graph's records are dataclasses whose node data stays numpy on the host:
`node_record_from_numpy` and `submap_record_from_numpy` convert those.
This module imports no jax.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from dliom_tpu_torch.backend.compression import CompressedGrid
from dliom_tpu_torch.backend.optimization import PoseGraphData
from dliom_tpu_torch.backend.pose_graph import NodeRecord, SubmapRecord
from dliom_tpu_torch.backend.precomputation import Pyramid
from dliom_tpu_torch.backend.submap_projection import SubmapImage
from dliom_tpu_torch.frontend.lio import LioResult, LioScanInput, LioState
from dliom_tpu_torch.frontend.local_trajectory_builder import FrontendState, ScanResult
from dliom_tpu_torch.imu.dynamic_initializer import InitResult
from dliom_tpu_torch.imu.initialization import AlignmentInput
from dliom_tpu_torch.imu.preintegration import NavState, Preintegrated
from dliom_tpu_torch.imu.window_optimizer import WindowState
from dliom_tpu_torch.mapping.brick_grid import BrickBank
from dliom_tpu_torch.mapping.motion_filter import MotionFilterState
from dliom_tpu_torch.mapping.submap import ActiveSubmaps
from dliom_tpu_torch.ops.ndt import NdtField
from dliom_tpu_torch.transform.rigid import Rigid3, np_rigid

_TYPES = {
    cls.__name__: cls
    for cls in (LioState, LioScanInput, LioResult, FrontendState, ScanResult, NavState,
                Preintegrated, WindowState, BrickBank, MotionFilterState, ActiveSubmaps, Rigid3,
                CompressedGrid, Pyramid, PoseGraphData, NdtField, AlignmentInput, InitResult)
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
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(x, device) for x in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree: Any) -> Any:
    """The port's NamedTuple tree of tensors -> the same tree of numpy arrays."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(x) for x in tree)
    return tree.detach().cpu().numpy()


def lio_state_from_numpy(tree, device) -> LioState:
    return to_torch(tree, device)


def lio_state_to_numpy(state: LioState) -> LioState:
    return to_numpy(state)


def lio_scan_input_from_numpy(tree, device) -> LioScanInput:
    return to_torch(tree, device)


def _host_pose(p) -> Rigid3:
    return None if p is None else np_rigid(Rigid3(np.asarray(p.rotation), np.asarray(p.translation)))


def node_record_from_numpy(node) -> NodeRecord:
    """A JAX NodeRecord (arrays already numpy) -> the port's, host data
    numpy, poses float64."""
    fields = {f.name: getattr(node, f.name) for f in dataclasses.fields(NodeRecord)}
    for k in ("high_points", "high_mask", "low_points", "low_mask", "histogram",
              "gravity_alignment"):
        fields[k] = np.asarray(fields[k])
    fields["local_pose"] = Rigid3(np.asarray(node.local_pose.rotation),
                                  np.asarray(node.local_pose.translation))
    fields["global_pose"] = _host_pose(node.global_pose)
    return NodeRecord(**fields)


def submap_record_from_numpy(sub, device) -> SubmapRecord:
    """A JAX SubmapRecord (arrays already numpy) -> the port's, grids as
    tensors on `device`, the image host numpy."""
    fields = {f.name: getattr(sub, f.name) for f in dataclasses.fields(SubmapRecord)}
    fields["local_pose"] = _host_pose(sub.local_pose)
    fields["global_pose"] = _host_pose(sub.global_pose)
    fields["high"] = to_torch(sub.high, device)
    fields["low"] = to_torch(sub.low, device)
    fields["histogram"] = None if sub.histogram is None else np.asarray(sub.histogram, np.float32)
    fields["node_ids"] = list(sub.node_ids)
    if sub.image is not None:
        fields["image"] = SubmapImage(np.asarray(sub.image.image), float(sub.image.meters_per_pixel))
    return SubmapRecord(**fields)

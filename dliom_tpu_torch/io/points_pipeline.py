"""Configurable points-processor pipeline.

Counterpart of the reference's assets-writer pipeline
(`cartographer/io/points_processor_pipeline_builder.{h,cc}` +
`cartographer_ros/assets_writer.cc`, R6): a declarative list of
``{"action": ...}`` stages — the same schema as the reference's Lua
`options.pipeline` (e.g. `src/dlio/config/assets_writer_tongji.lua`) —
applied to per-node world-frame point batches streamed from an optimized
pose graph, with terminal writer stages flushing map products.

Supported actions (reference points-processor names):
  min_max_range_filter {min_range, max_range}  — range measured from the
      observing node's world origin (min_max_range_filtering_points_processor)
  fixed_ratio_sampler {sampling_ratio}
  voxel_filter {voxel_size} — global first-point-per-voxel dedup
  dump_num_points
  write_ply {filename}
  write_pcd {filename}
  write_xray_image {filename, voxel_size}
  write_probability_grid {filename}

Everything is host-side numpy: this is post-hoc product generation, not
the compute path. A copy of dliom_tpu/io/points_pipeline.py.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List

import numpy as np

from dliom_tpu_torch.io.assets_writer import (
    iter_world_clouds,
    snapshot_node_clouds,
    voxel_dedup,
    write_pcd,
    write_ply,
    write_probability_grid_npz,
    write_xray_pgm,
)

_LOG = logging.getLogger("dliom_tpu_torch.points_pipeline")


class _Stage:
    def process(self, points: np.ndarray, origin: np.ndarray) -> np.ndarray:
        return points

    def flush(self) -> None:
        pass


class _MinMaxRange(_Stage):
    def __init__(self, out_dir, spec):
        self.min = float(spec.get("min_range", 0.0))
        self.max = float(spec.get("max_range", np.inf))

    def process(self, points, origin):
        r = np.linalg.norm(points - origin, axis=-1)
        return points[(r >= self.min) & (r <= self.max)]


class _FixedRatioSampler(_Stage):
    def __init__(self, out_dir, spec):
        self.ratio = float(spec["sampling_ratio"])
        self._acc = 0.0

    def process(self, points, origin):
        # per-point fixed-ratio sampling (fixed_ratio_sampling_points_processor)
        n = len(points)
        idx = np.floor(self._acc + self.ratio * np.arange(1, n + 1))
        prev = np.floor(self._acc + self.ratio * np.arange(n))
        keep = idx > prev
        self._acc = float(self._acc + self.ratio * n) % 1.0
        return points[keep]


class _VoxelFilter(_Stage):
    def __init__(self, out_dir, spec):
        self.size = float(spec["voxel_size"])
        self._seen: set = set()

    def process(self, points, origin):
        return voxel_dedup(points, self.size, seen=self._seen)


class _DumpNumPoints(_Stage):
    def __init__(self, out_dir, spec):
        self.count = 0

    def process(self, points, origin):
        self.count += len(points)
        return points

    def flush(self):
        _LOG.info("points pipeline: %d points", self.count)


class _Collector(_Stage):
    """Base for terminal writers: accumulates, writes on flush."""

    def __init__(self, out_dir, spec):
        self.path = os.path.join(out_dir, spec["filename"])
        self.spec = spec
        self._pts: List[np.ndarray] = []

    def process(self, points, origin):
        self._pts.append(np.asarray(points, np.float32))
        return points

    def _all(self) -> np.ndarray:
        return (
            np.concatenate(self._pts)
            if self._pts
            else np.zeros((0, 3), np.float32)
        )


class _WritePly(_Collector):
    def flush(self):
        write_ply(self.path, self._all())


class _WritePcd(_Collector):
    def flush(self):
        write_pcd(self.path, self._all())


class _WriteXray(_Collector):
    def flush(self):
        write_xray_pgm(
            self.path, self._all(), float(self.spec.get("voxel_size", 0.2))
        )


_ACTIONS = {
    "min_max_range_filter": _MinMaxRange,
    "fixed_ratio_sampler": _FixedRatioSampler,
    "voxel_filter": _VoxelFilter,
    "dump_num_points": _DumpNumPoints,
    "write_ply": _WritePly,
    "write_pcd": _WritePcd,
    "write_xray_image": _WriteXray,
}


def build_pipeline(pipeline: List[Dict], out_dir: str) -> List[_Stage]:
    """Instantiate stages from the declarative spec (the
    PointsProcessorPipelineBuilder analog; unknown actions raise, matching
    the reference's CHECK on unregistered names)."""
    stages = []
    for spec in pipeline:
        action = spec.get("action")
        if action == "write_probability_grid":
            # handled at run level (needs the pose graph, not point batches)
            stages.append(("probability_grid", spec))
            continue
        if action not in _ACTIONS:
            raise KeyError(
                f"unknown points-processor action {action!r}; "
                f"have {sorted(_ACTIONS)} + ['write_probability_grid']"
            )
        stages.append((action, spec))
    return stages


def run_pipeline(pose_graph, pipeline: List[Dict], out_dir: str) -> dict:
    """Stream every node's world-frame cloud through the stage chain
    (assets_writer.cc main loop: nodes in time order, each batch carries
    its sensor origin), then flush the writers. Returns per-stage stats."""
    os.makedirs(out_dir, exist_ok=True)
    specs = build_pipeline(pipeline, out_dir)
    stages: List[_Stage] = []
    for action, spec in specs:
        if action == "probability_grid":
            continue
        stages.append(_ACTIONS[action](out_dir, spec))

    snapshot = snapshot_node_clouds(pose_graph)
    for pts, origin in iter_world_clouds(snapshot):
        for stage in stages:
            pts = stage.process(pts, origin)
            if len(pts) == 0:
                break
    for stage in stages:
        stage.flush()
    for action, spec in specs:
        if action == "probability_grid":
            write_probability_grid_npz(
                os.path.join(out_dir, spec["filename"]), pose_graph
            )
    return {
        "num_points": next(
            (s.count for s in stages if isinstance(s, _DumpNumPoints)), None
        ),
        "stages": [a for a, _ in specs],
    }

"""Map product export (assets writer).

Counterpart of the reference's points-processor pipeline
(`cartographer_ros/assets_writer.{h,cc}` + `cartographer/io/points_processor`
ply/pcd/xray/probability-grid writers): post-hoc generation of map products
from an optimized pose graph —

  * `write_ply` / `write_pcd`: the aggregate point cloud (node clouds under
    optimized poses — the full-map cloud the reference's viewer republishes,
    node.cc:313-354);
  * `write_xray_pgm`: a top-down intensity projection (xray writer analog;
    PGM because the image is dependency-free);
  * `write_probability_grid_npz`: the stitched occupied cells of finished
    submaps with global poses.

Port of dliom_tpu/io/assets_writer.py: node clouds are host numpy already;
the finished submaps' compressed grids are tensors on the pose graph's device
and are read back once per submap.
"""

from __future__ import annotations

import numpy as np
import torch

from dliom_tpu_torch.backend.pose_graph import PoseGraph
from dliom_tpu_torch.mapping import probability as pv
from dliom_tpu_torch.transform.rigid import np_quat_rotate, np_rigid


def snapshot_node_clouds(pose_graph: PoseGraph, use_low: bool = False):
    """Raw host refs (global_pose, cloud, mask) per node — NOTHING is
    materialized here (no device→host sync). Take this under the graph
    owner's lock; all D2H transfers and transforms happen in
    `iter_world_clouds`/`aggregate_point_cloud` outside it, so a large
    map's aggregation never stalls the ingest/SLAM thread."""
    return [
        (
            n.global_pose,
            n.low_points if use_low else n.high_points,
            n.low_mask if use_low else n.high_mask,
        )
        for n in pose_graph.nodes
    ]


def iter_world_clouds(snapshot):
    """Yield (points_world (N, 3) f64, origin (3,) f64) per snapshot node.
    Pure-numpy transforms (zero device dispatch): this runs over EVERY
    node, and per-node device applies would serialize on the dispatch path
    and stall whoever is polling. Shared by the aggregate
    export and the points pipeline so the transform semantics can't
    drift."""
    for pose, cloud, mask in snapshot:
        q = np.asarray(pose.rotation, np.float64)
        t = np.asarray(pose.translation, np.float64)
        pts = np.asarray(cloud, np.float64)[np.asarray(mask)]
        yield np_quat_rotate(q, pts) + t, t


def aggregate_point_cloud(
    pose_graph: PoseGraph = None, use_low: bool = False, snapshot=None
) -> np.ndarray:
    """Node clouds transformed by optimized global poses -> (N, 3)."""
    if snapshot is None:
        snapshot = snapshot_node_clouds(pose_graph, use_low)
    pts = [world for world, _origin in iter_world_clouds(snapshot)]
    if not pts:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(pts).astype(np.float32)


def voxel_dedup(
    points: np.ndarray, voxel_size: float, seen: set | None = None
) -> np.ndarray:
    """First-point-per-voxel dedup (voxel_filtering_and_removing_moving_objects
    spirit; the hash-set VoxelFilter's host analog). With `seen` (a set of
    cell-key bytes) the dedup is streaming across batches. Vectorized:
    np.unique finds per-batch first occurrences; only the batch's unique
    cells touch the Python set."""
    points = np.asarray(points)
    if len(points) == 0:
        return points
    cells = np.floor(points / float(voxel_size)).astype(np.int64)
    _, first = np.unique(cells, axis=0, return_index=True)
    first = np.sort(first)
    if seen is None:
        return points[first]
    keep = []
    for row in first:
        key = cells[row].tobytes()
        if key not in seen:
            seen.add(key)
            keep.append(row)
    return points[keep]


def write_ply(path: str, points: np.ndarray) -> None:
    """Binary little-endian PLY (io/ply_writing_points_processor analog)."""
    points = np.asarray(points, np.float32)
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        f.write(header.encode())
        f.write(points.astype("<f4").tobytes())


def write_pcd(path: str, points: np.ndarray) -> None:
    """Binary PCD v0.7 (io/pcd_writing_points_processor analog)."""
    points = np.asarray(points, np.float32)
    with open(path, "wb") as f:
        header = (
            "# .PCD v0.7 - Point Cloud Data file format\n"
            "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
            "COUNT 1 1 1\n"
            f"WIDTH {len(points)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(points)}\nDATA binary\n"
        )
        f.write(header.encode())
        f.write(points.astype("<f4").tobytes())


def xray_image(points: np.ndarray, resolution: float = 0.2):
    """Top-down point-count projection (xray writer analog). Returns
    (uint8 image (W, H), origin_xy (2,)) — the live occupancy surface
    (occupancy_grid_node_main.cc's repainted grid; queried over RPC here
    instead of published on a ROS topic)."""
    if len(points) == 0:
        return np.zeros((1, 1), np.uint8), np.zeros(2, np.float32)
    xy = np.asarray(points)[:, :2]
    mins = xy.min(axis=0)
    cells = np.floor((xy - mins) / resolution).astype(np.int64)
    w, h = cells.max(axis=0) + 1
    img = np.zeros((int(w), int(h)), np.float64)
    np.add.at(img, (cells[:, 0], cells[:, 1]), 1.0)
    img = np.log1p(img)
    img = (img / max(img.max(), 1e-9) * 255).astype(np.uint8)
    return img, mins.astype(np.float32)


def write_xray_pgm(
    path: str, points: np.ndarray, resolution: float = 0.2
) -> None:
    """Top-down point-count projection as a PGM image (xray writer analog)."""
    img, _ = xray_image(points, resolution)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def write_probability_grid_npz(path: str, pose_graph: PoseGraph) -> None:
    """Stitched occupied cells of finished submaps in world coordinates."""
    all_pts, all_p = [], []
    spec = pose_graph._hi_spec
    for s in pose_graph.submaps:
        if not s.finished or s.high is None:
            continue
        idx = s.high.indices.detach().cpu().numpy()
        val = s.high.values.detach().cpu().numpy()
        keep = val > 0
        idx, val = idx[keep], val[keep]
        e = spec.extent
        cz = idx % e
        cy = (idx // e) % e
        cx = idx // (e * e)
        cells = np.stack([cx, cy, cz], -1) - spec.half
        local = cells.astype(np.float32) * spec.resolution
        pose = np_rigid(s.global_pose)
        world = (np_quat_rotate(pose.rotation, local.astype(np.float64))
                 + pose.translation).astype(np.float32)
        all_pts.append(world)
        all_p.append(pv.value_to_probability(torch.from_numpy(val.astype(np.int32))).numpy())
    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32)
    probs = np.concatenate(all_p) if all_p else np.zeros((0,), np.float32)
    np.savez_compressed(
        path, points=pts, probabilities=probs, resolution=spec.resolution
    )

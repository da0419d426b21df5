"""Dataset loaders / converters.

Counterpart of the reference's ingestion surfaces: offline bag replay
(cartographer_ros/offline_node.cc), the per-LiDAR-model point readers in
SensorBridge (ouster `t`, velodyne `time`, robosense `timestamp` per-point
fields, sensor_bridge.cc:183-235), and dataset-specific launch configs
(NTU-VIRAL / KAIST / KITTI / TONGJI).

Everything converts into the engine's canonical .npz sequence format (see
runner/offline.py):

  scans/<k>/points (N, 3) f32, scans/<k>/times (N,) f32 (<=0, end=0),
  scans/<k>/stamp () f64
  imu/times (M,), imu/acc (M, 3), imu/gyr (M, 3)
  gt/times (K,), gt/positions (K, 3)     [optional]

`convert_rosbag` imports `rosbag` when it is called and raises a clear
error where that package is not installed. A copy of dliom_tpu/io/datasets.py
(numpy only).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from dliom_tpu_torch.io.pointcloud_formats import decode_points


def load_kitti_velodyne_bin(path: str) -> np.ndarray:
    """One KITTI velodyne .bin -> (N, 4) x, y, z, intensity."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def convert_kitti_sequence(
    velodyne_dir: str,
    out_path: str,
    timestamps: Optional[Sequence[float]] = None,
    scan_period: float = 0.1,
    imu: Optional[Dict[str, np.ndarray]] = None,
    gt: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    max_scans: Optional[int] = None,
) -> int:
    """KITTI raw velodyne directory -> canonical .npz sequence. KITTI scans
    carry no per-point times; they are synthesized over the scan period
    (matching the reference's eable_mannually_discrew path for KITTI,
    src/dlio/config/kitti.lua)."""
    files = sorted(glob.glob(os.path.join(velodyne_dir, "*.bin")))
    if max_scans:
        files = files[:max_scans]
    data = {}
    for k, f in enumerate(files):
        pts = load_kitti_velodyne_bin(f)[:, :3]
        stamp = timestamps[k] if timestamps is not None else k * scan_period
        data[f"scans/{k}/points"] = pts
        data[f"scans/{k}/times"] = np.linspace(
            -scan_period, 0.0, len(pts)
        ).astype(np.float32)
        data[f"scans/{k}/stamp"] = np.float64(stamp)
    if imu is not None:
        data["imu/times"] = np.asarray(imu["times"], np.float64)
        data["imu/acc"] = np.asarray(imu["acc"], np.float32)
        data["imu/gyr"] = np.asarray(imu["gyr"], np.float32)
    else:
        data["imu/times"] = np.zeros(0, np.float64)
        data["imu/acc"] = np.zeros((0, 3), np.float32)
        data["imu/gyr"] = np.zeros((0, 3), np.float32)
    if gt is not None:
        data["gt/times"], data["gt/positions"] = gt
    np.savez_compressed(out_path, **data)
    return len(files)


# Per-point time field per LiDAR model (SensorBridge::HandlePointCloud2Message)
POINT_TIME_FIELDS = {
    "ouster": ("t", 1e-9, "relative to scan start (ns)"),
    "velodyne": ("time", 1.0, "relative seconds"),
    "robosense": ("timestamp", 1.0, "absolute seconds"),
}


def convert_rosbag(
    bag_path: str,
    out_path: str,
    points_topics: Sequence[str],
    imu_topic: str,
    sensor_type: str = "ouster",
    max_scans: Optional[int] = None,
) -> int:
    """ROS bag -> canonical .npz. Requires the `rosbag` package (available in
    ROS environments). Per-point times are rebased so the last point is 0
    (sensor_bridge.cc:183-235)."""
    try:
        import rosbag  # type: ignore
        import sensor_msgs.point_cloud2 as pc2  # type: ignore
    except ImportError as e:
        raise ImportError(
            "rosbag/sensor_msgs are required for bag conversion; run this "
            "converter inside a ROS environment and copy the .npz over"
        ) from e

    field = POINT_TIME_FIELDS[sensor_type][0]
    data = {}
    imu_t, imu_a, imu_g = [], [], []
    k = 0
    with rosbag.Bag(bag_path) as bag:
        for topic, msg, t in bag.read_messages(
            topics=list(points_topics) + [imu_topic]
        ):
            if topic == imu_topic:
                imu_t.append(msg.header.stamp.to_sec())
                imu_a.append(
                    [msg.linear_acceleration.x, msg.linear_acceleration.y,
                     msg.linear_acceleration.z]
                )
                imu_g.append(
                    [msg.angular_velocity.x, msg.angular_velocity.y,
                     msg.angular_velocity.z]
                )
                continue
            if max_scans and k >= max_scans:
                continue
            names = [f.name for f in msg.fields]
            has_time = field in names
            want = ["x", "y", "z"] + ([field] if has_time else [])
            rows = list(pc2.read_points(msg, field_names=want, skip_nans=True))
            # one decoder: route through decode_points (the SensorBridge
            # analog) so stamp/rebase conventions cannot diverge from the
            # online ingest path
            arr64 = np.asarray(rows, np.float64).reshape(len(rows), len(want))
            if has_time:
                rec = np.zeros(
                    len(rows),
                    dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                           (field, "f8")],
                )
                if len(rows):
                    rec["x"], rec["y"], rec["z"] = (
                        arr64[:, 0], arr64[:, 1], arr64[:, 2]
                    )
                    rec[field] = arr64[:, 3]
                stamp, pts, rel = decode_points(
                    rec, sensor_type, msg.header.stamp.to_sec()
                )
            else:
                stamp, pts, rel = decode_points(
                    arr64[:, :3].astype(np.float32), "generic",
                    msg.header.stamp.to_sec(),
                )
            data[f"scans/{k}/points"] = pts
            data[f"scans/{k}/times"] = rel.astype(np.float32)
            data[f"scans/{k}/stamp"] = np.float64(stamp)
            k += 1
    data["imu/times"] = np.asarray(imu_t, np.float64)
    data["imu/acc"] = np.asarray(imu_a, np.float32)
    data["imu/gyr"] = np.asarray(imu_g, np.float32)
    np.savez_compressed(out_path, **data)
    return k


def convert_ntu_viral(bag_path: str, out_path: str,
                      max_scans: Optional[int] = None) -> int:
    """NTU VIRAL bag (e.g. eee_01.bag) -> canonical .npz, with the exact
    topic wiring of the reference's demo (demo_dlio_viral.launch:28-30:
    imu:=/imu/imu, points2:=/os1_cloud_node1/points — the horizontal
    Ouster OS1-16; the second LiDAR is commented out in the demo too).

    Full reproduction of the reference's NTU VIRAL eval (BASELINE.md ATE
    target), to run in any ROS environment with the bag downloaded from
    https://ntu-aris.github.io/ntu_viral_dataset/ :

      python -c "from dliom_tpu_torch.io.datasets import convert_ntu_viral; \\
                 convert_ntu_viral('eee_01.bag', 'eee_01.npz')"
      python -m dliom_tpu_torch.runner.offline --dataset eee_01.npz \\
          --preset viral --output-csv eee_01_traj.csv

    then compare the CSV against the dataset's ground truth
    (`/leica/pose/relative` topic / the published ATE tooling) — the same
    eval loop as the reference's offline_node replay +
    WriteTrajectoryForDLIO (offline_node.cc, map_builder_bridge.cc:310).
    The repo does not bundle the bag."""
    return convert_rosbag(
        bag_path, out_path,
        points_topics=["/os1_cloud_node1/points"],
        imu_topic="/imu/imu",
        sensor_type="ouster",
        max_scans=max_scans,
    )


def write_npz_sequence(
    out_path: str,
    scans: Sequence[Tuple[float, np.ndarray, Optional[np.ndarray]]],
    imu_times: np.ndarray,
    imu_acc: np.ndarray,
    imu_gyr: np.ndarray,
    gt: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> None:
    """Assemble a canonical sequence from in-memory arrays."""
    data = {}
    for k, (stamp, pts, times) in enumerate(scans):
        data[f"scans/{k}/points"] = np.asarray(pts, np.float32)
        data[f"scans/{k}/times"] = (
            np.asarray(times, np.float32)
            if times is not None
            else np.zeros(len(pts), np.float32)
        )
        data[f"scans/{k}/stamp"] = np.float64(stamp)
    data["imu/times"] = np.asarray(imu_times, np.float64)
    data["imu/acc"] = np.asarray(imu_acc, np.float32)
    data["imu/gyr"] = np.asarray(imu_gyr, np.float32)
    if gt is not None:
        data["gt/times"], data["gt/positions"] = gt
    np.savez_compressed(out_path, **data)

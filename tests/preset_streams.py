"""Reduced extents and a sensor stream that every shipped preset can map,
shared by the preset tests of the port.

`REDUCE` cuts the capacities of a preset (grid extents, brick pools, point
and pose-graph capacities) and nothing of its algorithm: resolutions,
inserter, matcher, IMU noise, initialization and insertion paths stay as
shipped. `stream` feeds the bubbles world of io/synthetic.py with a level
body at 100 Hz IMU, a scan per `scan_period`: a preset with static
initialization stands still for its static frames, then accelerates with
tests/test_dynamic_init.py's time-varying acceleration (1.4 cos 1.8t,
1.0 sin 1.8t); a preset with NDT initialization moves from the start.
"""

import numpy as np

from dliom_tpu_torch.io.synthetic import SyntheticWorld
from dliom_tpu_torch.transform.rigid import Rigid3

G = 9.80511
REDUCE = {
    "trajectory_builder": {
        "max_raw_points": 32768,
        "max_filtered_points": 2048,
        "max_high_res_points": 256,
        "max_low_res_points": 256,
        "submaps": {"high_resolution_extent": 96, "low_resolution_extent": 48,
                    "brick_dir_extent": 32, "brick_max_bricks": 4096,
                    "low_brick_dir_extent": 16, "low_brick_max_bricks": 1024},
    },
    "pose_graph": {"max_submaps": 16, "max_nodes": 64, "max_constraints": 256,
                   "max_num_final_iterations": 4, "optimize_every_n_nodes": 0},
}


def stream(num_scans, tb, rate=100):
    """Events (kind, time, payload) in feed order for a trajectory builder
    config `tb`: each scan, then the IMU samples up to the next one."""
    world = SyntheticWorld.create()
    period = tb.scan_period
    still = 0 if tb.enable_ndt_initialization else tb.frames_for_static_initialization + 1
    g_w = np.array([0.0, 0.0, -G])
    p, v, t = np.zeros(3), np.zeros(3), 0.0
    m = int(round(period * rate))
    sub = period / m
    events = []
    for k in range(num_scans):
        pts, ptimes = world.cast_scan(Rigid3(np.asarray([1.0, 0, 0, 0], np.float32),
                                             np.asarray(p, np.float32)))
        events.append(("scan", t, (pts, ptimes)))
        for i in range(m):
            tau = t + (i + 0.5) * sub
            a_w = np.zeros(3) if k < still else np.array(
                [1.4 * np.cos(1.8 * tau), 1.0 * np.sin(1.8 * tau), 0.0])
            events.append(("imu", t + (i + 1) * sub,
                           ((a_w - g_w).astype(np.float32), np.zeros(3, np.float32))))
            p = p + v * sub + 0.5 * a_w * sub * sub
            v = v + a_w * sub
        t += period
    return events


def feed(builder, events):
    for kind, t, payload in events:
        if kind == "imu":
            builder.add_imu_data(t, *payload)
        else:
            builder.add_range_data(t, *payload)
    builder.flush()

"""The general traffic generator: a mix is a data file
(benchmark/traffic/<mix>.json) of parameters, read here with the
configuration's sensor and IMU (benchmark/configs/<config>.json).

Every lane drives the closed course of `world.Course`. Its world (the
bubbles) and its phase on the course come from the seed, as does the IMU
noise; the lap's scans are cast on the device once, at set-up, and cycled,
so the trajectory stays continuous while the stamps keep increasing. The
same seed gives the same inputs.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from benchmark import world

CAST_SCANS = 8  # scans per cast call
MAX_STEPS = 1 << 20  # stamps made: steps a run can take


class Lap(NamedTuple):
    """A lap of every lane, resident on the device, lap index first."""

    points: torch.Tensor  # (N, L, R, 3) float32, sensor frame
    times: torch.Tensor  # (R,) per-point relative times (all 0: a snapshot per scan)
    mask: torch.Tensor  # (R,) bool
    imu_dts: torch.Tensor  # (N, L, M)
    imu_acc: torch.Tensor  # (N, L, M, 3)
    imu_gyr: torch.Tensor  # (N, L, M, 3)
    imu_mask: torch.Tensor  # (N, L, M) bool
    stamps: torch.Tensor  # (S,) scan stamps of steps 0.., float32
    starts: List[tuple]  # per lane: rotation, position, velocity, ba, bg at its first scan
    imu_samples: int  # valid IMU samples a scan


def seeds(seed: int, n: int) -> List[int]:
    """n independent 63-bit seeds from the run's seed (any whole number)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(s.generate_state(2, np.uint64)[0] >> np.uint64(1)) for s in ss.spawn(n)]


def make_lap(spec: dict, traffic: dict, seed: int, device: torch.device, lanes: int) -> Lap:
    sensor, imu = spec["sensor"], spec["imu"]
    course = world.Course(traffic["radius_m"], traffic["lap_scans"], spec["scan_period"])
    n_lap = course.lap_scans
    lane_seeds = seeds(seed, 2 * lanes + 1)
    phase_rng = np.random.default_rng(lane_seeds[-1])
    rays = torch.as_tensor(world.directions(sensor["num_beams"], sensor["num_azimuths"],
                                            sensor["two_rangefinders"]), device=device)
    m_cap = imu["capacity"]
    points, dts, accs, gyrs, masks, starts = [], [], [], [], [], []
    bias0 = torch.tensor(imu["gyr_bias0"], dtype=torch.float64, device=device)
    for b in range(lanes):
        phase = int(phase_rng.integers(n_lap))
        centres = torch.as_tensor(world.bubbles(sensor["num_bubbles"], lane_seeds[2 * b] % 2**32),
                                  device=device)
        k = torch.arange(phase, phase + n_lap + 1, device=device)
        rot, pos, vel = course.pose(k)
        scans = [world.cast(centres, rays, rot[lo + 1:lo + 1 + CAST_SCANS], pos[lo + 1:lo + 1 + CAST_SCANS])
                 for lo in range(0, n_lap, CAST_SCANS)]
        points.append(torch.cat(scans))
        sub, acc, gyr = world.imu_between(rot[:-1], rot[1:], vel[:-1], vel[1:], course.scan_period,
                                          imu["rate_hz"], spec["gravity"])
        gen = torch.Generator(device=device)
        gen.manual_seed(lane_seeds[2 * b + 1])
        n = acc.shape[1]
        if n > m_cap:
            raise ValueError(f"{n} IMU samples a scan exceed the capacity {m_cap}")
        acc = acc + imu["acc_noise"] * torch.randn(acc.shape, generator=gen, dtype=acc.dtype, device=device)
        gyr = gyr + bias0 + imu["gyr_noise"] * torch.randn(gyr.shape, generator=gen, dtype=gyr.dtype,
                                                          device=device)
        pad = (0, 0, 0, m_cap - n)
        accs.append(torch.nn.functional.pad(acc, pad).float())
        gyrs.append(torch.nn.functional.pad(gyr, pad).float())
        valid = torch.arange(m_cap, device=device) < n
        dts.append(torch.where(valid, sub, 0.0).float().expand(n_lap, m_cap))
        masks.append(valid.expand(n_lap, m_cap))
        zero = np.zeros(3)
        starts.append((rot[0].float().cpu().numpy(), pos[0].float().cpu().numpy(),
                       vel[0].float().cpu().numpy(), zero, np.asarray(imu["gyr_bias0"])))
    n_rays = rays.shape[0]
    stamps = (torch.arange(1, MAX_STEPS + 1, dtype=torch.float64, device=device)
              * course.scan_period).float()
    return Lap(points=torch.stack(points, 1), times=torch.zeros(n_rays, device=device),
               mask=torch.ones(n_rays, dtype=torch.bool, device=device),
               imu_dts=torch.stack(dts, 1).contiguous(), imu_acc=torch.stack(accs, 1),
               imu_gyr=torch.stack(gyrs, 1), imu_mask=torch.stack(masks, 1).contiguous(),
               stamps=stamps, starts=starts, imu_samples=n)


def scan_input(lap: Lap, step: int, input_type, lane=None):
    """The input of step `step` (lap index step mod N) as `input_type`
    (a LioScanInput): every lane's scan stacked, or lane `lane`'s alone,
    or the only lane's unstacked where the lap has one."""
    j = step % lap.points.shape[0]
    lanes = lap.points.shape[1]
    if lane is None and lanes > 1:
        n_rays = lap.times.shape[0]
        return input_type(time=lap.stamps[step].expand(lanes), points=lap.points[j],
                          times=lap.times.expand(lanes, n_rays), mask=lap.mask.expand(lanes, n_rays),
                          imu_dts=lap.imu_dts[j], imu_acc=lap.imu_acc[j], imu_gyr=lap.imu_gyr[j],
                          imu_mask=lap.imu_mask[j])
    b = 0 if lane is None else lane
    return input_type(time=lap.stamps[step], points=lap.points[j, b], times=lap.times, mask=lap.mask,
                      imu_dts=lap.imu_dts[j, b], imu_acc=lap.imu_acc[j, b], imu_gyr=lap.imu_gyr[j, b],
                      imu_mask=lap.imu_mask[j, b])

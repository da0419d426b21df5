"""The benchmark's device world against the port's host world
(dliom_tpu_torch/io/synthetic.py), of which it is a frozen copy."""

import numpy as np
import pytest
import torch

from benchmark import generator, world
from dliom_tpu_torch.io.synthetic import ImuSimulator, SyntheticWorld
from dliom_tpu_torch.transform.rigid import Rigid3

COURSE = world.Course(radius=5.0, lap_scans=30, scan_period=0.1)


@pytest.mark.parametrize("two", [True, False])
def test_cast_matches_the_synthetic_world(two):
    host = SyntheticWorld.create(num_bubbles=20, num_azimuths=32, seed=7, two_rangefinders=two)
    assert np.array_equal(host.bubbles, world.bubbles(20, 7))
    rays = world.directions(16, 32, two)
    assert np.array_equal(host.directions, rays)
    rot, pos, _ = COURSE.pose(torch.arange(0, 30, 7))
    got = world.cast(torch.as_tensor(host.bubbles), torch.as_tensor(rays), rot, pos)
    for i in range(rot.shape[0]):
        want, times = host.cast_scan(Rigid3(rot[i].numpy(), pos[i].numpy()))
        np.testing.assert_allclose(got[i].numpy(), want, atol=2e-5)
        assert not times.any()


def test_imu_matches_the_simulator():
    sim = ImuSimulator(rate=400.0, gravity=9.80511)
    rot, pos, vel = COURSE.pose(torch.arange(0, 4))
    sub, acc, gyr = world.imu_between(rot[:-1], rot[1:], vel[:-1], vel[1:], 0.1, 400.0, 9.80511)
    for i in range(3):
        dts, a, g, mask = sim.between(Rigid3(rot[i].numpy(), pos[i].numpy()),
                                      Rigid3(rot[i + 1].numpy(), pos[i + 1].numpy()),
                                      vel[i].numpy(), vel[i + 1].numpy(), 0.1, 48)
        n = int(mask.sum())
        assert n == acc.shape[1] == 40
        np.testing.assert_allclose(dts[:n], sub, rtol=1e-6)
        np.testing.assert_allclose(a[:n], acc[i].numpy(), atol=2e-5)
        np.testing.assert_allclose(g[:n], gyr[i].numpy(), atol=2e-6)


def test_the_course_closes():
    rot0, pos0, vel0 = COURSE.pose(0)
    rot1, pos1, vel1 = COURSE.pose(COURSE.lap_scans)
    for a, b in ((rot0.abs(), rot1.abs()), (pos0, pos1), (vel0, vel1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)


SPEC = {"scan_period": 0.1, "gravity": 9.80511,
        "sensor": {"num_beams": 16, "num_azimuths": 16, "two_rangefinders": True, "num_bubbles": 10},
        "imu": {"rate_hz": 400.0, "capacity": 48, "acc_noise": 0.02, "gyr_noise": 0.002,
                "gyr_bias0": [0.0, 0.0, 0.004]}}
MIX = {"radius_m": 5.0, "lap_scans": 12}


def test_the_lap_comes_from_the_seed():
    seed = 2**31 + 12345
    a = generator.make_lap(SPEC, MIX, seed, torch.device("cpu"), 2)
    b = generator.make_lap(SPEC, MIX, seed, torch.device("cpu"), 2)
    c = generator.make_lap(SPEC, MIX, seed + 1, torch.device("cpu"), 2)
    for x, y, z in zip(a[:8], b[:8], c[:8]):
        assert torch.equal(x, y)
    assert not torch.equal(a.points, c.points)
    assert not torch.equal(a.imu_acc, c.imu_acc)
    assert a.points.shape == (12, 2, 512, 3) and a.imu_samples == 40
    assert int(a.imu_mask[0, 0].sum()) == 40 and a.imu_dts[0, 0, 40:].abs().sum() == 0

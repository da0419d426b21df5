"""tools/torch_e2e_loop_ate.py against tools/e2e_loop_ate.py.

- `course`: the first 20 scans (16 static, then the circle) against the
  JAX tool's loop rebuilt from `dliom_tpu.io.synthetic`: stamps exact, the
  static scans bit for bit; on the circle the true quaternion differs in
  its last bits (the JAX tool takes cos and sin of the half yaw in float32,
  the port in float64 rounded to float32: up to 2 ulp apart), which moves
  IMU samples by <= 1e-6 and points by <= 1e-4 m.
- `main` and `evaluate` against the JAX tool's `main` (its `current_ate`
  and `endpoint_err`) on the same poses: both tools drive the same stand-in
  builder, which makes nodes in the static phase too and an INTER
  constraint, with E2E_DEBUG on; their printed lines are the same text.
- `main(["--device", "cpu"])` through the port's MapBuilder at a short
  E2E_LAPS prints the JAX tool's two JSON lines, keys and all; run by
  tools/torch_e2e_accuracy.py, whose pairing by node time finds the 2
  static-phase nodes (and at phase 8's bench_e2e config, shortened).
- The tool runs on the card unless told otherwise, and imports no JAX.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dliom_tpu.io.synthetic import ImuNoise, ImuSimulator, SyntheticWorld
import torch_threads  # noqa: F401  (one torch thread per test process)

ROOT = Path(__file__).resolve().parents[1]
PORT_TOOL = ROOT / "tools" / "torch_e2e_loop_ate.py"
JAX_TOOL = ROOT / "tools" / "e2e_loop_ate.py"
ACCURACY_TOOL = ROOT / "tools" / "torch_e2e_accuracy.py"
SCANS = 20


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return load(PORT_TOOL, "torch_e2e_loop_ate")


def jax_course(jt, n_scans):
    """The JAX tool's feed loop (tools/e2e_loop_ate.py:105-131), its
    builder calls replaced by recording them."""
    world = SyntheticWorld.create(num_beams=16, num_azimuths=600)
    sim = ImuSimulator(rate=100.0, noise=ImuNoise(acc_noise=0.02, gyr_noise=0.002,
                                                  gyr_bias0=(0.0, 0.0, 0.004)), gravity=jt.G, seed=4)
    out, t = [], 0.0
    pose0, _ = jt.circle_pose(0.0)
    prev_pose, prev_v, tau = pose0, np.zeros(3), 0.0
    for k in range(n_scans):
        if k < int(round(jt.REST / jt.SCAN_PERIOD)):
            pose, v = pose0, np.zeros(3)
            a, b, va = pose0, pose0, np.zeros(3)
        else:
            tau += jt.SCAN_PERIOD
            pose, v = jt.circle_pose(tau)
            a, b, va = prev_pose, pose, prev_v
        dts, accs, gyrs, mask = sim.between(a, b, va, v, jt.SCAN_PERIOD, 64)
        imu = []
        for i in range(int(np.asarray(mask).sum())):
            t += float(dts[i])
            imu.append((t, np.asarray(accs[i]), np.asarray(gyrs[i])))
        pts, ptimes = world.cast_scan(pose)
        out.append((imu, t, pts, ptimes, pose))
        prev_pose, prev_v = pose, v
    return out


def test_course_matches_the_jax_tools_loop(port):
    jt = load(JAX_TOOL, "jax_e2e_loop_ate")
    assert port.N_REST == int(round(jt.REST / jt.SCAN_PERIOD)) == 16
    assert (port.G, port.RADIUS, port.SPEED, port.SCAN_PERIOD) == (jt.G, jt.RADIUS, jt.SPEED, jt.SCAN_PERIOD)
    for k, (a, b) in enumerate(zip(port.course(SCANS), jax_course(jt, SCANS), strict=True)):
        imu_a = np.array([[t, *acc, *gyr] for t, acc, gyr in a[0]])
        imu_b = np.array([[t, *acc, *gyr] for t, acc, gyr in b[0]])
        assert imu_a.shape == imu_b.shape and a[1] == b[1]
        np.testing.assert_array_equal(imu_a[:, 0], imu_b[:, 0])
        np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_array_equal(a[4].translation, np.asarray(b[4].translation))
        if k < port.N_REST:
            np.testing.assert_array_equal(imu_a, imu_b)
            np.testing.assert_array_equal(a[2], b[2])
        else:
            np.testing.assert_allclose(imu_a, imu_b, rtol=0, atol=1e-6)
            np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-4)
            np.testing.assert_allclose(a[4].rotation, np.asarray(b[4].rotation), rtol=0, atol=2.5e-7)


class StandInGraph:
    """The graph surface both tools read: nodes with a time and a global
    pose, submaps, constraints; the final optimization pulls every node
    halfway to the origin of its error."""

    def __init__(self):
        identity = SimpleNamespace(rotation=np.array([1.0, 0, 0, 0]), translation=np.zeros(3))
        self.nodes, self.submaps, self.constraints = [], [SimpleNamespace(global_pose=identity)], []

    def wait_for_all_computations(self):
        pass

    def num_inter_constraints(self):
        return sum(c.tag == "INTER" for c in self.constraints)

    def run_final_optimization(self):
        for n in self.nodes:
            p = n.global_pose
            n.global_pose = SimpleNamespace(rotation=p.rotation, translation=0.5 * p.translation)


class StandInBuilder:
    """Makes a node for every other scan after the 8th (in the static phase
    too, as the real builder does), at a pose that drifts off the circle,
    and an INTER constraint on the fifth node."""

    def __init__(self, cfg, device=None):
        self.pose_graph = StandInGraph()
        self.scans = 0

    def add_imu_data(self, t, acc, gyr):
        pass

    def add_range_data(self, t, points, point_times):
        self.scans += 1
        pg = self.pose_graph
        if self.scans <= 8 or self.scans % 2:
            return None
        ang = 0.3 * max(t - 1.6, 0.0)
        p = np.array([5.0 * np.sin(ang), 5.0 * (1.0 - np.cos(ang)), 0.0]) + 0.02 * t * np.array([1.0, -0.5, 0.2])
        pose = SimpleNamespace(rotation=np.array([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)]), translation=p)
        pg.nodes.append(SimpleNamespace(time=t, global_pose=pose))
        if len(pg.nodes) == 5:
            pg.constraints.append(SimpleNamespace(
                tag="INTER", submap_id=0, node_id=4, score=0.61,
                relative=SimpleNamespace(rotation=pose.rotation, translation=p + np.array([0.3, 0.0, 0.0]))))
        return {}


def test_main_matches_the_jax_tool_on_the_same_poses(port, monkeypatch, capsys):
    monkeypatch.setenv("E2E_LAPS", "0.1")
    monkeypatch.setenv("E2E_DEBUG", "1")
    jt = load(JAX_TOOL, "jax_e2e_loop_ate_short")
    monkeypatch.setattr(jt, "MapBuilder", StandInBuilder)
    monkeypatch.setattr(port, "MapBuilder", StandInBuilder)
    jt.main()
    want = capsys.readouterr().out
    lines = port.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "INTER s0 n4" in got and got.count("\nscan ") >= 9
    assert [json.loads(x) for x in got.splitlines() if x.startswith("{")] == lines


def test_main_runs_the_port_on_the_cpu(monkeypatch, capsys):
    """The tool's `main` through the port's MapBuilder, run by
    tools/torch_e2e_accuracy.py, which also reads the graph with the truth
    paired by node time: the static phase made 2 of the nodes, which the
    tool's pairing holds against moving truth."""
    monkeypatch.setenv("E2E_LAPS", "0.02")
    acc = load(ACCURACY_TOOL, "torch_e2e_accuracy").main(["--device", "cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    lines = printed[:2]
    assert printed[2] == acc
    assert [x["phase"] for x in lines] == ["pre_final_optimization", "post_final_optimization"]
    assert set(lines[0]) == {"phase", "ate_rmse_m", "endpoint_err_m", "num_inter", "num_nodes", "num_submaps"}
    assert set(lines[1]) == {"phase", "ate_rmse_m", "endpoint_err_m", "improvement"}
    assert lines[0]["num_nodes"] >= 2 and lines[0]["num_submaps"] >= 1
    assert np.isfinite(lines[0]["ate_rmse_m"]) and np.isfinite(lines[1]["ate_rmse_m"])
    assert acc["static_nodes"] == 2 and acc["before"]["num_nodes"] == lines[0]["num_nodes"]
    assert acc["before"]["ate_rmse_m"] < lines[0]["ate_rmse_m"]


def test_accuracy_at_bench_e2e_config(monkeypatch, tmp_path):
    """tools/torch_e2e_accuracy.py --config bench_e2e on a shortened
    course (27 scans: 16 static, 11 moving): pool threads, pipeline depth
    1, truth by node time, the pairs file written (no INTER yet)."""
    tool = load(ACCURACY_TOOL, "torch_e2e_accuracy")
    monkeypatch.setattr(tool, "BENCH_E2E_SCANS", 27)
    acc = tool.main(["--config", "bench_e2e", "--device", "cpu", "--pairs", str(tmp_path / "pairs.npz")])
    assert np.load(tmp_path / "pairs.npz").files == []
    assert acc["static_nodes"] == 2 and acc["after"]["num_nodes"] == acc["before"]["num_nodes"] >= 3
    assert np.isfinite(acc["before"]["ate_rmse_m"]) and acc["inter"] == []


def test_ground_truth_by_time_pairs_each_node_with_its_scan(port):
    stamps = np.array([0.1, 0.2, 0.3, 0.4])
    positions = np.arange(12.0).reshape(4, 3)
    pg = SimpleNamespace(nodes=[SimpleNamespace(time=0.2), SimpleNamespace(time=0.4)])
    gt = port.ground_truth_by_time(pg, stamps, positions)
    assert [t for t, _ in gt] == [0.2, 0.4]
    np.testing.assert_array_equal(np.stack([p for _, p in gt]), positions[[1, 3]])


def test_cuda_without_a_card_raises(port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main([])


def test_imports_no_jax():
    code = (f"import importlib.util, sys; s = importlib.util.spec_from_file_location('t', {str(PORT_TOOL)!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'dliom_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"

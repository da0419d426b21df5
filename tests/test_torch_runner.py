"""The port's offline runner (`python -m dliom_tpu_torch.runner.offline`)
against the JAX package's (dliom_tpu/runner/offline.py), on the CPU.

A short `write_npz_sequence` dataset (tests/test_torch_map_builder.py's
stream: static start, then 0.05 m per scan along x; ground truth at the
scan stamps) replays through both runners with every export on: the report
has the JAX runner's keys and the same counts, ATE within 1e-3 m, the
trajectory CSV within POSE_ATOL, the exported state loads into the other
package, and every product file is written. The CLI then replays against
the port's saved state in pure localization with a torch.profiler trace.
The dataset loader and the synthetic corkscrew sequence equal the JAX
package's.
"""

import argparse
import json
import os

import numpy as np
import pytest

from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.io.serialization import load_state as j_load_state
from dliom_tpu.runner import offline as JR
from dliom_tpu_torch.io.datasets import write_npz_sequence
from dliom_tpu_torch.io.serialization import load_state as t_load_state
from dliom_tpu_torch.runner import offline as TR
from test_torch_map_builder import POSE_ATOL, G, _overrides, _stream
from test_torch_serialization import CPU
import torch_threads  # noqa: F401  (one torch thread per test process)

SCANS = 7  # initialized on the 4th scan; the 7th finishes submap 0
OUTPUTS = {"output_csv": "traj.csv", "output_state": "state.npz", "output_pbstream": "map.pbstream",
           "output_range_data": "range.pbstream", "output_kitti": "traj.kitti",
           "output_tum": "traj.tum", "output_relations": "relations.csv", "output_ply": "map.ply",
           "output_xray": "map.pgm"}
PIPELINE = [{"action": "voxel_filter", "voxel_size": 0.1}, {"action": "dump_num_points"},
            {"action": "write_pcd", "filename": "points.pcd"}]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("runner")
    scans, imu_t, stamps, gt_x = [], [], [], []
    for kind, _, t, payload in _stream(SCANS):
        if kind == "imu":
            imu_t.append(t)
        else:
            scans.append((t, *payload))
            stamps.append(t)
            gt_x.append(0.05 * max(0, len(stamps) - 4))
    n = len(imu_t)
    gt = (np.asarray(stamps), np.stack([gt_x, np.zeros(SCANS), np.zeros(SCANS)], -1))
    path = str(d / "seq.npz")
    write_npz_sequence(path, scans, np.asarray(imu_t), np.tile([0.0, 0.0, G], (n, 1)), np.zeros((n, 3)), gt)
    with open(d / "pipeline.json", "w") as f:
        json.dump(PIPELINE, f)
    return d, path


def _args(out_dir, dataset, **kw):
    args = dict(dataset=dataset, preset="basic", config_overrides=json.dumps(_overrides()),
                relations_min_covered_distance=100.0, verbose=False, load_state=None,
                pure_localization=False, profile=None, assets_pipeline=None, assets_dir=None,
                device="cpu")
    args.update({k: os.path.join(out_dir, v) for k, v in OUTPUTS.items()})
    args.update(kw)
    return argparse.Namespace(**args)


def _run(runner, d, path, out):
    out.mkdir()
    return runner.run(_args(str(out), path, assets_pipeline=str(d / "pipeline.json"),
                            assets_dir=str(out / "assets")))


@pytest.fixture(scope="module")
def port_run(dataset):
    """The port runner's report and output directory on the dataset."""
    d, path = dataset
    return _run(TR, d, path, d / "port"), d / "port"


def test_runner_matches_jax(dataset, port_run, tmp_path):
    d, path = dataset
    want = _run(JR, d, path, tmp_path / "jax")
    got, port_dir = port_run
    assert set(got) == set(want)
    for k in ("map_frame", "tracking_frame", "num_scans", "num_matched", "num_nodes", "num_submaps",
              "num_constraints", "num_loop_constraints", "num_relations", "num_relation_outliers"):
        assert got[k] == want[k], k
    assert got["num_nodes"] > 0 and got["num_submaps"] >= 2
    for k in ("ate_rmse_m", "ate_rmse_aligned_m", "pre_optimization_ate_rmse_m"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    # the voxel filter runs on optimized poses, which differ within 1e-3 m
    assert got["assets_pipeline"]["stages"] == want["assets_pipeline"]["stages"]
    assert abs(got["assets_pipeline"]["num_points"] / want["assets_pipeline"]["num_points"] - 1) < 0.02
    for key, name in OUTPUTS.items():
        assert os.path.getsize(got[{"output_csv": "trajectory_csv", "output_state": "state_file",
                                    "output_pbstream": "pbstream_file",
                                    "output_range_data": "range_data_file",
                                    "output_kitti": "kitti_file", "output_tum": "tum_file",
                                    "output_relations": "relations_file", "output_ply": "ply_file",
                                    "output_xray": "xray_file"}[key]]) > 0, name
    np.testing.assert_allclose(np.loadtxt(port_dir / "traj.csv"),
                               np.loadtxt(tmp_path / "jax" / "traj.csv"), atol=POSE_ATOL)
    over = _overrides()
    assert len(j_load_state(str(port_dir / "state.npz"), j_load_config("basic", over)).nodes) \
        == len(t_load_state(str(tmp_path / "jax" / "state.npz"), None, device=CPU).nodes) == got["num_nodes"]


def test_cli_localizes_against_saved_state_with_profile(dataset, port_run, tmp_path, capsys):
    d, path = dataset
    first, port_dir = port_run
    state = str(port_dir / "state.npz")
    # the first 5 scans of the dataset: initialized on the 4th, 2 live nodes
    z = dict(np.load(path))
    short = str(tmp_path / "short.npz")
    np.savez_compressed(short, **{k: v for k, v in z.items()
                                  if not k.startswith("scans/") or int(k.split("/")[1]) < 5})
    TR.main(["--dataset", short, "--device", "cpu", "--config-overrides", json.dumps(_overrides()),
             "--load-state", state, "--pure-localization", "--profile", str(tmp_path / "prof")])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.getsize(report["profile_trace"]) > 0
    # the loaded map's nodes plus the live trajectory's
    assert report["num_scans"] == 5 and report["num_nodes"] == first["num_nodes"] + 2


def test_dataset_loader_matches_jax(dataset):
    _, path = dataset
    want, got = JR._load_npz_dataset(path), TR._load_npz_dataset(path)
    assert len(got[0]) == len(want[0]) == SCANS and len(got[1]) == len(want[1])
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(y, x)
    for x, y in zip(want[2], got[2]):
        np.testing.assert_array_equal(y, x)


def test_synthetic_dataset_matches_jax():
    want, got = JR._synthetic_dataset(), TR._synthetic_dataset()
    assert len(got[0]) == len(want[0]) and len(got[1]) == len(want[1])
    for a, b in zip(want[0], got[0]):
        # the corkscrew's rotations: float64 then float32 here, float32 in JAX
        assert a[0] == b[0]
        np.testing.assert_allclose(b[1], a[1], atol=1e-5)
        np.testing.assert_array_equal(b[2], a[2])
    for a, b in zip(want[1], got[1]):
        assert abs(a[0] - b[0]) < 1e-12
        np.testing.assert_allclose(b[1], a[1], atol=1e-5)
        np.testing.assert_allclose(b[2], a[2], atol=1e-6)
    for x, y in zip(want[2], got[2]):
        np.testing.assert_array_equal(y, x)

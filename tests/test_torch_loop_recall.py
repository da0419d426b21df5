"""tools/torch_loop_recall.py against tools/loop_recall.py.

- The port's `_cfg` equals tests/test_pose_graph.py::_cfg field by field.
- `_make_node` gives the JAX helper's arrays (the histogram within 1e-6,
  relative: its buckets reach ~10 and are float32 sums in another order);
  `_place_cloud` the same clouds and `place_grids` the same grids, bit for
  bit.
- `run_trial(1000, num_places=2)` on the CPU returns the JAX tool's dict.
- The tool runs on the card unless told otherwise, and imports no JAX.
"""

import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.mapping import probability as jpv
from dliom_tpu.mapping.grid import cell_index, make_grid, set_cells
from dliom_tpu.mapping.submap import grid_specs
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from test_pose_graph import _cfg as j_cfg
from test_pose_graph import _make_node as j_make_node
import torch_threads  # noqa: F401  (one torch thread per test process)

ROOT = Path(__file__).resolve().parents[1]
PORT_TOOL = ROOT / "tools" / "torch_loop_recall.py"
JAX_TOOL = ROOT / "tools" / "loop_recall.py"


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return load(PORT_TOOL, "torch_loop_recall"), load(JAX_TOOL, "jax_loop_recall")


def _tree(obj):
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, [(f.name, _tree(getattr(obj, f.name))) for f in dataclasses.fields(obj)])
    return obj


def test_cfg_equals_the_pose_graph_tests(tools):
    port, _ = tools
    assert dataclasses.asdict(port._cfg()) == dataclasses.asdict(j_cfg())
    assert _tree(port._cfg()) == _tree(j_cfg())


def test_place_clouds_grids_and_nodes_match(tools):
    port, jt = tools
    cfg = port._cfg()
    a, b = port._place_cloud(np.random.default_rng(1001)), jt._place_cloud(np.random.default_rng(1001))
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)

    hi, lo = grid_specs(j_cfg().trajectory_builder.submaps)
    vals = jnp.full((b.shape[0],), jpv.probability_to_value(jnp.float32(0.9)))
    want = [set_cells(make_grid(s), cell_index(jnp.asarray(b), s.resolution), vals, s) for s in (hi, lo)]
    for g, w in zip(port.place_grids(a, *grid_specs(cfg.trajectory_builder.submaps), "cpu"), want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    pose = JRigid3.translation_only(jnp.asarray([30.0, 0.0, 0.0]))
    jn = j_make_node(j_cfg(), b, pose)
    tn = port._make_node(cfg, a, port.Rigid3(port.IDENTITY, np.asarray([30.0, 0.0, 0.0])))
    assert (tn.time, tn.submap_ids) == (jn.time, jn.submap_ids)
    for f in ("high_points", "high_mask", "low_points", "low_mask", "gravity_alignment"):
        np.testing.assert_array_equal(getattr(tn, f), np.asarray(getattr(jn, f)))
        assert getattr(tn, f).dtype == np.asarray(getattr(jn, f)).dtype
    # float32 sums over 1200 points in another order: up to 2 ulp apart
    np.testing.assert_allclose(tn.histogram, np.asarray(jn.histogram), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tn.local_pose.translation, np.asarray(jn.local_pose.translation))
    np.testing.assert_array_equal(tn.local_pose.rotation, np.asarray(jn.local_pose.rotation))


def test_run_trial_equals_the_jax_tools(tools):
    port, jt = tools
    keep = {}
    got = port.run_trial(1000, num_places=2, device="cpu", keep=keep)
    assert got == jt.run_trial(1000, num_places=2)
    assert got == {"recall": 1.0, "precision": 1.0, "closed": 1.0, "false_constraints": 0}
    assert set(keep["proposals"]) == {0} and keep["node_id"] == 2


def test_cuda_without_a_card_raises(tools, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tools[0].main(["1"])


def test_imports_no_jax():
    code = (f"import importlib.util, sys; s = importlib.util.spec_from_file_location('t', {str(PORT_TOOL)!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'dliom_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"

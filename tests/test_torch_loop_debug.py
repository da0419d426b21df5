"""tools/torch_loop_debug.py against tools/loop_debug.py.

- `score_at_pose` on the port's graph carried across from a JAX graph
  (tests/test_torch_long_course.py::jax_loop_graph) equals the JAX tool's
  per-pair formula (tools/loop_debug.py:134-177) computed with
  `dliom_tpu`'s functions on the JAX graph, within 1e-6, at the true
  relative pose, a perturbed one and one whose clouds fall mostly outside
  the cropped grids.
- `main` against the JAX tool's `main` with the runner replaced by the same
  graph in each package: the same missed pairs in the same order, the same
  printed lines.
- The tool runs on the card unless told otherwise, and imports no JAX.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.backend.precomputation import lookup, probability_from_byte
from dliom_tpu.mapping.grid import cell_index, interpolated_probability
from dliom_tpu.runner import offline as j_offline
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from test_torch_long_course import carried_with_inter, jax_loop_graph
import torch_threads  # noqa: F401  (one torch thread per test process)

ROOT = Path(__file__).resolve().parents[1]
PORT_TOOL = ROOT / "tools" / "torch_loop_debug.py"
JAX_TOOL = ROOT / "tools" / "loop_debug.py"


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return load(PORT_TOOL, "torch_loop_debug")


@pytest.fixture(scope="module")
def graphs():
    _, jpg, gt, _ = jax_loop_graph()
    return jpg, carried_with_inter(jpg), gt


def jax_scores(pg, sid, node, gt_rel):
    """tools/loop_debug.py:134-177 on a JAX graph."""
    hi, lo = pg._hi_spec, pg._lo_spec
    _, g_lo, pyr = pg._decompressed_grids(sid)
    hp, hm = jnp.asarray(node.high_points), jnp.asarray(node.high_mask)
    lp, lm = jnp.asarray(node.low_points), jnp.asarray(node.low_mask)
    cells = cell_index(gt_rel.apply(hp), hi.resolution)
    vals = lookup(pyr.levels[0], cells, hi.half)
    inb = jnp.all((cells + hi.half >= 0) & (cells + hi.half < hi.extent), axis=-1) & hm
    n_valid = jnp.maximum(jnp.sum(hm.astype(jnp.float32)), 1.0)
    score_all = probability_from_byte(jnp.sum(jnp.where(hm, vals, 0).astype(jnp.float32)) / n_valid)
    n_in = jnp.maximum(jnp.sum(inb.astype(jnp.float32)), 1.0)
    score_in = probability_from_byte(jnp.sum(jnp.where(inb, vals, 0).astype(jnp.float32)) / n_in)
    lo_cells = cell_index(gt_rel.apply(lp), lo.resolution)
    lo_inb = jnp.all((lo_cells + lo.half >= 0) & (lo_cells + lo.half < lo.extent), axis=-1) & lm
    p_low = interpolated_probability(g_lo, gt_rel.apply(lp), lo)
    n_lo = jnp.maximum(jnp.sum(lm.astype(jnp.float32)), 1.0)
    low_all = jnp.sum(jnp.where(lm, p_low, 0.0)) / n_lo
    n_lo_in = jnp.maximum(jnp.sum(lo_inb.astype(jnp.float32)), 1.0)
    low_in = jnp.sum(jnp.where(lo_inb, p_low, 0.0)) / n_lo_in
    return {k: float(v) for k, v in jax.device_get({
        "score_all": score_all, "score_inbounds": score_in, "hi_frac_in": n_in / n_valid,
        "low_all": low_all, "low_inbounds": low_in, "lo_frac_in": n_lo_in / n_lo}).items()}


@pytest.mark.parametrize("offset", [(0.0, 0.0, 0.0, 0.0), (0.3, -0.2, 0.1, 0.05), (20.0, 6.0, 0.0, 0.4)],
                         ids=["true", "perturbed", "mostly_outside"])
def test_score_at_pose_equals_jax(port, graphs, offset):
    jpg, pg, (_, gt_q, gt_p) = graphs
    q, p = port.lc._np_rigid_inv_compose(gt_q[0], gt_p[0], gt_q[8], gt_p[8])
    yaw = np.array([np.cos(offset[3] / 2), 0.0, 0.0, np.sin(offset[3] / 2)])
    q = port.lc._np_quat_multiply(yaw, q).astype(np.float32)
    p = (p + np.asarray(offset[:3])).astype(np.float32)
    want = jax_scores(jpg, 0, jpg.nodes[8], JRigid3(jnp.asarray(q), jnp.asarray(p)))
    got = port.score_at_pose(pg, 0, pg.nodes[8], port.Rigid3(q, p))
    assert list(got) == list(port.SCORE_KEYS) and set(got) == set(want)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=0, atol=1e-6)
    if offset[0] == 0.0:
        assert got["score_all"] > 0.8 and got["hi_frac_in"] == 1.0
    if offset[0] > 5.0:
        assert got["hi_frac_in"] < 0.6 and got["lo_frac_in"] < 1.0


def test_main_equals_the_jax_tool_on_the_same_graph(port, graphs, tmp_path, monkeypatch, capsys):
    jpg, pg, (times, gt_q, gt_p) = graphs
    path = str(tmp_path / "gt.npz")
    np.savez(path, **{"gt/times": times, "gt/rotations": gt_q, "gt/positions": gt_p})
    report = {"num_scans": 10, "num_nodes": 10, "phase_seconds": {"spa": 1.0}}

    def jax_run(args, on_builder=None):
        on_builder(SimpleNamespace(pose_graph=jpg), dict(report))
        return dict(report)

    def port_replay(path, device, overrides=None, verbose=False, on_builder=None):
        on_builder(SimpleNamespace(pose_graph=pg), dict(report))
        return dict(report)

    jt = load(JAX_TOOL, "jax_loop_debug")
    monkeypatch.setattr(j_offline, "run", jax_run)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)  # no compile cache in the repo
    monkeypatch.setattr(sys, "argv", ["loop_debug.py", "--dataset", path])
    jt.main()
    want = capsys.readouterr().out
    monkeypatch.setattr(port.lc, "replay", port_replay)
    lines = port.main(["--dataset", path, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "missed gt-close pairs: 2" in got and len(lines) == 1 + 2


def test_cuda_without_a_card_raises(port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main(["--dataset", "none.npz"])


def test_imports_no_jax():
    code = (f"import importlib.util, sys; s = importlib.util.spec_from_file_location('t', {str(PORT_TOOL)!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'dliom_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"

"""The compiled step (dliom_tpu_torch/common/graph.py, `make_jit_lio_step`,
`make_jit_lio_chunk`, the batched `make_batched_lio_step`) on the CPU,
where `StepGraph` runs its body eagerly through the same static buffers
and copies that a CUDA graph replays on the card:

(a) after a warm-up call, one compiled step issues no op that a CUDA graph
    capture refuses (a host read, a tensor built from host data, an op
    whose output size depends on the data), outside K1's and K2's plain
    versions (the card runs the kernels there): `lio_step` at a brick and
    a dense config and at `campus` and `viral`, and the batched step at
    B = 2 (brick and dense);
(b) the fixed-trip LM (all iterations, converged lanes frozen) equals the
    early exit (`host_exit=True`) bit for bit in pose, cost and
    iterations, at one lane and at B = 3, where every lane converges
    before `max_iterations`;
(c) `make_jit_lio_chunk(cfg, 3)` over two chunks equals the eager
    `run_lio_chunk` over the same six scans bit for bit, state and results;
(d) the same chunks against the JAX package's `make_jit_lio_chunk(cfg, 3)`
    at tests/test_torch_lio.py's tolerances (pose within 2e-3, flags and
    integer state equal, under 0.1% of touched pool cells different);
(e) a MapBuilder, which steps through the compiled step on the CPU as on
    the card, at pipeline_depth 1 returns the results of one stepped by the
    eager `lio_step` and writes its checkpoint (taken between steps), bit
    for bit; the static buffers a step overwrites do not reach what it
    kept.

The configs and scans are tests/test_torch_lio.py's (single lane),
tests/test_torch_batch.py's (B = 2) and tests/test_torch_map_builder.py's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

import preset_streams
import test_torch_batch as tbatch
import test_torch_lio as tlio
import test_torch_map_builder as tmb
from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.frontend.lio import make_jit_lio_chunk as j_make_jit_lio_chunk
from dliom_tpu.frontend.lio import make_lio_state as j_make_lio_state
from dliom_tpu.imu import preintegration as JP
from dliom_tpu_torch import map_builder as TMB
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.frontend.lio import (
    LioScanInput,
    lio_step,
    make_jit_lio_chunk,
    make_jit_lio_step,
    make_lio_state,
    run_lio_chunk,
)
from dliom_tpu_torch.frontend import local_trajectory_builder as ltb
from dliom_tpu_torch.imu import preintegration as pre
from dliom_tpu_torch.interop import lio_scan_input_from_numpy, lio_state_from_numpy, to_numpy
from dliom_tpu_torch.mapping.grid import GridSpec, set_cells
from dliom_tpu_torch.ops.scan_matcher import match
from dliom_tpu_torch.parallel import batch as TBatch
from dliom_tpu_torch.transform.rigid import Rigid3
import torch_threads  # noqa: F401  (one torch thread per test process)
from torch_capture_audit import audited as _audited

CPU = torch.device("cpu")
CHUNK = 3
def _lio_cfg():
    return t_load_config("basic", tlio.OVERRIDES).trajectory_builder


def _fresh(cfg):
    return make_lio_state(cfg, pre.NavState.identity(CPU), torch.zeros(3), torch.zeros(3))


@pytest.fixture(scope="module")
def lio_scans():
    return tlio._scans()


def _stacked(scans):
    return LioScanInput(*(torch.stack(x) for x in zip(*(lio_scan_input_from_numpy(s, CPU) for s in scans))))


def _copied(tree):
    """Copies of a tree's tensors (`to_numpy` of a CPU tensor shares its memory)."""
    return tree_map(lambda x: None if x is None else x.clone(), tree)


@pytest.mark.parametrize("grids", ["brick", "dense", "campus", "viral"])
def test_compiled_step_issues_no_uncapturable_op(grids, lio_scans, monkeypatch):
    """Also at `campus` (per-record dense insert, the gravity factor) and
    `viral` (per-record brick insert), cut by tests/preset_streams.py."""
    if grids in ("campus", "viral"):
        cfg = t_load_config(grids, preset_streams.REDUCE).trajectory_builder
    else:
        cfg = (_lio_cfg() if grids == "brick"
               else t_load_config("basic", tbatch._overrides(False)).trajectory_builder)
    scans = [tbatch._lane(s, 0) for s in tbatch._scans()] if grids == "dense" else lio_scans
    step = make_jit_lio_step(cfg)
    state, _ = step(_fresh(cfg), lio_scan_input_from_numpy(scans[0], CPU))  # the warm-up
    second = lio_scan_input_from_numpy(scans[1], CPU)
    mode = _audited(monkeypatch, lambda: step(state, second))
    assert mode.ops > 1000 and not mode.found, dict(mode.found)


@pytest.mark.parametrize("brick", [True, False], ids=["brick", "dense"])
def test_compiled_batched_step_issues_no_uncapturable_op(brick, monkeypatch):
    cfg = t_load_config("basic", tbatch._overrides(brick)).trajectory_builder
    scans = [lio_scan_input_from_numpy(s, CPU) for s in tbatch._scans(n_scans=2)]
    step = TBatch.make_batched_lio_step(cfg, tbatch.B)
    state, _ = step(TBatch.make_batched_lio_state(cfg, tbatch.B, CPU), scans[0])
    mode = _audited(monkeypatch, lambda: step(state, scans[1]))
    assert mode.ops > 1000 and not mode.found, dict(mode.found)


def test_eager_step_reads_the_host_only_in_the_early_exit(lio_scans, monkeypatch):
    """The audit sees what it looks for: the eager `lio_step` with the LM's
    early exit (`match(host_exit=True)`) reads the host once per
    iteration, and nowhere else."""
    cfg = _lio_cfg()
    monkeypatch.setattr(ltb, "match", functools.partial(match, host_exit=True))
    state, _ = lio_step(_fresh(cfg), lio_scan_input_from_numpy(lio_scans[0], CPU), cfg)
    second = lio_scan_input_from_numpy(lio_scans[1], CPU)
    mode = _audited(monkeypatch, lambda: lio_step(state, second, cfg))
    assert set(mode.found) == {"aten._local_scalar_dense.default"}, dict(mode.found)


def _matcher_case():
    """tests/test_torch_batch.py's LM case: one dense grid of three planes,
    three initial offsets that converge on different iterations, each
    before `max_iterations` (raised from 12 to 20)."""
    spec = GridSpec(0.1, 64)
    rng = np.random.default_rng(3)
    surface = np.concatenate([
        np.stack([rng.uniform(-2, 2, 400), rng.uniform(-2, 2, 400), np.full(400, -1.0)], 1),
        np.stack([np.full(400, 2.0), rng.uniform(-2, 2, 400), rng.uniform(-1, 1, 400)], 1),
        np.stack([rng.uniform(-2, 2, 400), np.full(400, 2.5), rng.uniform(-1, 1, 400)], 1),
    ]).astype(np.float32)
    cells = torch.round(torch.from_numpy(surface) / spec.resolution).to(torch.int32)
    grid = set_cells(torch.zeros(2 * spec.num_cells, dtype=torch.int16), cells, 30000, spec)
    pts = torch.from_numpy(surface[::4].copy())
    kw = dict(specs=[spec], occupied_space_weights=[1.0], translation_weight=0.1,
              rotation_weight=0.1, max_iterations=20, function_tolerance=1e-2)
    return grid, pts, torch.ones(pts.shape[0], dtype=torch.bool), kw


@pytest.mark.parametrize("lanes", [1, 3])
def test_fixed_trip_lm_equals_early_exit(lanes):
    grid, pts, mask, kw = _matcher_case()
    offsets = [(0.0, 0.0, 0.0), (0.02, -0.01, 0.01), (0.04, -0.03, 0.02)][:lanes]
    if lanes == 1:
        init = Rigid3(torch.tensor([1.0, 0, 0, 0]), torch.tensor(offsets[0], dtype=torch.float32))
        args = dict(clouds=[(pts, mask)], grids=[grid], grid_bases=[0])
    else:
        init = Rigid3(torch.tensor([[1.0, 0, 0, 0]] * lanes), torch.tensor(offsets, dtype=torch.float32))
        args = dict(clouds=[(pts.expand(lanes, -1, -1), mask.expand(lanes, -1))], grids=[grid],
                    grid_bases=[torch.zeros(lanes, dtype=torch.int32)])
    early = match(init, **args, host_exit=True, **kw)
    fixed = match(init, **args, **kw)
    iters = early.iterations.reshape(-1)
    assert bool((iters < kw["max_iterations"]).all()), iters  # every lane exits early
    for name in ("iterations", "cost", "initial_cost"):
        assert torch.equal(getattr(fixed, name), getattr(early, name)), name
    assert torch.equal(fixed.pose.rotation, early.pose.rotation)
    assert torch.equal(fixed.pose.translation, early.pose.translation)


@pytest.fixture(scope="module")
def chunk_runs(lio_scans):
    """The compiled chunk over two chunks and the eager loop over the same
    six scans, on the CPU."""
    cfg = _lio_cfg()
    eager_state, eager_results = run_lio_chunk(
        _fresh(cfg), [lio_scan_input_from_numpy(s, CPU) for s in lio_scans], cfg)
    fn = make_jit_lio_chunk(cfg, CHUNK)
    state, results = _fresh(cfg), []
    for k in range(0, len(lio_scans), CHUNK):
        state, res = fn(state, _stacked(lio_scans[k:k + CHUNK]))
        results.append(to_numpy(_copied(res)))  # the next call rewrites the graph's result buffers
    return (to_numpy(eager_state), [to_numpy(r) for r in eager_results]), (to_numpy(state), results), fn


def test_chunk_equals_eager_loop(chunk_runs):
    (eager_state, eager_results), (state, results), fn = chunk_runs
    assert fn.counts()["steps"] == 2
    for a, b in zip(tree_flatten(eager_state)[0], tree_flatten(state)[0]):
        assert (a is None and b is None) or np.array_equal(a, b)
    for k, eager in enumerate(eager_results):
        for a, b in zip(tree_flatten(eager)[0], tree_flatten(results[k // CHUNK])[0]):
            assert (a is None and b is None) or np.array_equal(a, b[k % CHUNK]), k


def test_chunk_matches_jax(chunk_runs, lio_scans):
    _, (state, results), _ = chunk_runs
    j_cfg = j_load_config("basic", tlio.OVERRIDES).trajectory_builder
    fn, split, join = j_make_jit_lio_chunk(j_cfg, CHUNK)
    j_state = j_make_lio_state(j_cfg, JP.NavState.identity(), jnp.zeros(3), jnp.zeros(3))
    # the port's initial state is the JAX one converted (tests/test_torch_lio.py)
    ref = to_numpy(lio_state_from_numpy(jax.tree.map(np.asarray, j_state), CPU))
    for a, b in zip(tree_flatten(ref)[0], tree_flatten(to_numpy(_fresh(_lio_cfg())))[0]):
        assert (a is None and b is None) or np.array_equal(a, b)
    grids, rest = split(j_state)
    j_results = []
    for k in range(0, len(lio_scans), CHUNK):
        stacked = jax.tree.map(lambda *x: jnp.stack([jnp.asarray(v) for v in x]), *lio_scans[k:k + CHUNK])
        grids, rest, res = fn(grids, rest, stacked)
        j_results.append(jax.tree.map(np.asarray, res))
    js = jax.tree.map(np.asarray, join(grids, rest))
    for jr, tr in zip(j_results, results):
        np.testing.assert_allclose(tr.scan.local_pose.translation, jr.scan.local_pose.translation,
                                   atol=tlio.POSE_ATOL)
        np.testing.assert_allclose(tr.scan.local_pose.rotation, jr.scan.local_pose.rotation,
                                   atol=tlio.POSE_ATOL)
        for f in ("inserted", "finished_submap", "matcher_iterations", "num_hits", "insertion_submap_ids"):
            np.testing.assert_array_equal(getattr(tr.scan, f), getattr(jr.scan, f), err_msg=f)
        np.testing.assert_array_equal(tr.failed, jr.failed)
    jsm, tsm = js.frontend.submaps, state.frontend.submaps
    assert int(tsm.num_created) == int(jsm.num_created) == 2  # crossed a spawn
    for name in ("high_brick", "low_brick"):
        jb, tb = getattr(jsm, name), getattr(tsm, name)
        for f in ("counts", "epochs", "dropped", "directory", "group_of_slot"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f"{name}.{f}")
        touched = (jb.pool != 0) | (tb.pool != 0)
        share = float(np.sum(jb.pool != tb.pool)) / max(int(touched.sum()), 1)
        assert share < 1e-3, (name, share)
    np.testing.assert_allclose(state.window.p, js.window.p, atol=tlio.POSE_ATOL)


def _checkpoint_arrays(builder, path):
    builder.save_checkpoint(str(path))
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_map_builder_compiled_keeps_what_it_retains(tmp_path):
    over = tmb._overrides()
    events = tmb._stream(9)
    builders = {c: TMB.MapBuilder(t_load_config("basic", over), pipeline_depth=1, device=CPU)
                for c in (False, True)}
    eager = builders[False].trajectory(0)  # the reference: the eager `lio_step` on fresh tensors
    eager._lio_step = lambda arrays: lio_step(
        eager._lio, LioScanInput(*(torch.from_numpy(np.asarray(a)) for a in arrays)), eager.tb)
    returned = {c: [] for c in builders}
    checkpoints = {c: [] for c in builders}
    scans = 0
    for kind, _, t, payload in events:
        for c, b in builders.items():
            if kind == "imu":
                b.add_imu_data(t, [0.0, 0.0, tmb.G], [0.0, 0.0, 0.0])
            else:
                returned[c].append(b.add_range_data(t, *payload))
        if kind == "scan":
            scans += 1
            if scans in (7, 8):  # mid-submap, between steps, the first submap finished
                for c, b in builders.items():
                    checkpoints[c].append(_checkpoint_arrays(b, tmp_path / f"{c}_{scans}.npz"))
    for b in builders.values():
        b.flush()
    step = builders[True].trajectory(0)._step
    assert step is not None and builders[False].trajectory(0)._step is None
    assert step.counts()["steps"] == len(builders[True].local_trajectory(0)) > 0
    assert sum(s.finished for s in builders[True].pose_graph.submaps) >= 1
    for a, b in zip(returned[False], returned[True]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a["time"] == b["time"] and a["inserted"] == b["inserted"]
            np.testing.assert_array_equal(a["local_pose"].translation, b["local_pose"].translation)
            np.testing.assert_array_equal(a["local_pose"].rotation, b["local_pose"].rotation)
            np.testing.assert_array_equal(a["velocity"], b["velocity"])
    for ea, ca in zip(*checkpoints.values()):
        assert sorted(ea) == sorted(ca)
        for k in ea:
            np.testing.assert_array_equal(ea[k], ca[k], err_msg=k)
    for a, b in zip(builders[False].pose_graph.submaps, builders[True].pose_graph.submaps):
        assert a.finished == b.finished

"""The mesh scale-out (dliom_tpu_torch/common/mesh.py and its users) on the
CPU, against the JAX package's sharded paths (dliom_tpu/parallel/batch.py
:311-411, backend/optimization.py:263-300, backend/pose_graph.py:141-147).

Every port mesh here is 4 shards on `cpu` (`Mesh((cpu,) * 4)`), which runs
the sharded code one shard after another; the JAX side uses 4 of
conftest's 8 virtual CPU devices.

(a) `shard_over_mesh` / `gather`: a round trip, lane-major pieces, and a
    lane count D does not divide raises;
(b) `sharded_lio_step` at tests/test_parallel.py:219-273's config, B = 8
    over D = 4, 3 steps: each shard bit for bit against the port's own
    `make_batched_lio_step(cfg, 2)` on its lanes (the same code on the
    same device), and against JAX's `sharded_lio_step`: the gathered
    initial state equal, integer banks bit for bit, poses and window poses
    within POSE_ATOL;
(c) the compiled `sharded_step` (the frontend; a `StepGraph` per shard)
    against JAX's at tests/test_parallel.py:95-112's config over two steps,
    and against the eager per-shard `batched_step` bit for bit;
(d) `solve(mesh=)` on tests/test_optimization.py::_build_problem (seed 3,
    6 GN steps of 48 CG steps) at D = 4 and at D = 3, which does not divide
    the 1024 constraint rows: within `solve_atol` (the order of the partial
    sums only; relative to the solve's movement) of the port's unsharded
    solve, also with the rows permuted so that every shard holds valid
    ones, each f32 solve within half of it of a float64 solve, and within
    5e-5 of JAX's sharded solve (tests/test_torch_backend.py's SPA
    tolerance); the SPA's compiled programs over the mesh
    (backend/pose_graph.py::_SpaPrograms, through `PoseGraph._solve`) on
    the same problem at D = 4 and 3, rows contiguous or spread: equal to
    the eager `solve(mesh=)` bit for bit, and each program free of ops a
    capture refuses;
(e) `PoseGraph(mesh=)` on tests/test_pose_graph.py:141-200's scenario:
    every search chunk's found flag, score and pose bit for bit against the
    unsharded port's, the INTER to submap 0 found within 0.3 m of the
    truth, the constraints against JAX's `PoseGraph(mesh=)`
    (tests/test_torch_pose_graph.py's tolerances), the final poses over the
    mesh (its compiled SPA programs) within `solve_atol` of the unsharded
    port's; one chunk of 5 nodes
    split 2 / 2 / 1 / 0: found and score equal to the unsharded chunk's,
    the refined poses within 1e-6 (the batched GN refinement of a piece
    rounds apart from that of the whole chunk); `MapBuilder(mesh=)` hands
    its mesh to its pose graph;
(f) the batched step's online correlative pre-search: the batched `match`
    bit for bit against each lane's own, and the batched LIO step with the
    pre-search on against JAX's at tests/test_torch_batch.py's brick
    config: with both lanes taking scans from the first step, integer
    banks bit for bit and poses within POSE_ATOL; with lane 1's first scan
    empty (the helper's default), what stays sound there: every step's
    flags, lane 0's poses and banks against JAX, each lane within LANE_ATOL
    of the port's own single-lane `lio_step`, and lane 1 against JAX (its
    poses, and the banks bit for bit) on the steps before LATE_LANE_PARTS.
    An empty first scan scores every candidate 0 and both packages take the
    lattice's corner candidate; the sliding window then pulls the pose back
    through its ill-conditioned f32 solve, and the packages part: 4.4e-4 m
    at that scan, 8.4e-4 m one scan on, 5.0e-2 m two scans on, in the
    single-lane `lio_step` as much as in the batched one. Settled as f32
    rounding (ROADMAP §3): tests/test_torch_lm_trace.py::
    test_late_lane_parts_in_the_window_solve holds every stage before the
    window's GN equal to JAX's and each package's f32 GN within its own
    rounding of a float64 GN.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from torch.utils._pytree import tree_leaves, tree_map

from dliom_tpu.backend import optimization as JO
from dliom_tpu.backend.pose_graph import PoseGraph as JPoseGraph
from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.frontend.lio import LioScanInput as JScan
from dliom_tpu.parallel import batch as JB
from dliom_tpu_torch.backend import optimization as TO
from dliom_tpu_torch.backend import pose_graph as TPG
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.common.mesh import Mesh, gather, make_mesh, shard_over_mesh, split_sizes
from dliom_tpu_torch.frontend.local_trajectory_builder import ScanInput
from dliom_tpu_torch.interop import lio_scan_input_from_numpy, lio_state_from_numpy, to_numpy, to_torch
from dliom_tpu_torch.map_builder import MapBuilder
from dliom_tpu_torch.mapping.submap import brick_spec
from dliom_tpu_torch.ops import real_time_correlative as TR
from dliom_tpu_torch.parallel import batch as TBatch
from dliom_tpu_torch.transform.rigid import Rigid3
from test_optimization import _build_problem
from test_parallel import _cfg as _frontend_cfg_j
from test_parallel import _scan_batch
from test_pose_graph import _cfg as _pg_cfg
from dliom_tpu_torch.frontend.lio import lio_step, make_lio_state
from dliom_tpu_torch.imu.preintegration import NavState
from test_torch_batch import LANE_ATOL, POSE_ATOL, _assert_banks_equal, _lane, _overrides, _scans
from test_torch_pose_graph import _port_config, _scenario
import torch_threads  # noqa: F401  (one torch thread per test process)
from torch_capture_audit import audited

CPU = torch.device("cpu")
D = 4
MESH = Mesh((CPU,) * D)
G = 9.80511
# Sharded against unsharded (the order of the partial sums only): chip_smoke.py::spa_tolerance's form,
# SOLVE_RTOL times the solve's largest node movement plus SOLVE_ULPS float32 spacings of the largest
# pose component, derived as there from a float64 solve of the same problem: on (d)'s problem every
# f32 solve (unsharded, sharded at D = 4 and 3, rows contiguous or spread) came within 1.62e-6 of it
# at a 0.92 m movement and poses up to 13.2 m (1.7 spacings), so r <= 1.8e-6 and k = 2. Two f32
# solves part by at most 2 (r moved + k spacing):
# SOLVE_RTOL >= 2 r, and the spacings, which dominate here, give (d) a gate of 7.5e-6 against the
# 9.5e-7 measured; (d) checks the premise every run.
SOLVE_RTOL = 4e-6
SOLVE_ULPS = 4
JAX_SOLVE_ATOL = 5e-5  # tests/test_torch_backend.py::test_spa_solve_matches
PRESEARCH_SCANS = 3  # (f): scans of the batched step with the pre-search
PIECE_POSE_ATOL = 1e-6  # a chunk's refined poses, its nodes split over shards against one batch
LATE_LANE_PARTS = 2  # (f): the scan at which a lane with an empty first scan parts from JAX by f32 rounding
# of its window's GN (docstring; tests/test_torch_lm_trace.py::test_late_lane_parts_in_the_window_solve)


def _jax_mesh(n, axis="seq"):
    return JMesh(np.array(jax.devices("cpu")[:n]), (axis,))


def _equal_trees(a, b, what):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert (x is None) == (y is None), what
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), what


# ----- (a) -----


def test_shard_and_gather_round_trip():
    x = torch.arange(8 * 3, dtype=torch.int32).reshape(8, 3)
    flat = torch.arange(16, dtype=torch.int16)
    shards = shard_over_mesh((x, None, flat), MESH)
    assert len(shards) == D
    for k, (xs, none, fs) in enumerate(shards):
        assert none is None
        assert torch.equal(xs, x[2 * k:2 * k + 2]) and torch.equal(fs, flat[4 * k:4 * k + 4])
        assert xs.data_ptr() != x[2 * k:].data_ptr()  # copies
    back = gather(shards, CPU)
    assert torch.equal(back[0], x) and back[1] is None and torch.equal(back[2], flat)
    assert back[0].data_ptr() != x.data_ptr()
    with pytest.raises(ValueError):
        shard_over_mesh(torch.zeros(6, 2), MESH)
    cfg = t_load_config("basic", _overrides(True)).trajectory_builder
    with pytest.raises(ValueError):
        TBatch.make_sharded_lio_state(cfg, 6, MESH)
    with pytest.raises(ValueError):
        TBatch.sharded_lio_step(cfg, 10, MESH)
    assert split_sizes(5, MESH) == [2, 2, 1, 0] and split_sizes(1, MESH) == [1, 0, 0, 0]
    assert make_mesh(1, device="cpu").devices == (CPU,)
    with pytest.raises(RuntimeError):
        make_mesh(2, device="cpu")
    assert MESH.distinct_devices == (CPU,) and MESH.first == CPU


# ----- (b) -----


def _lio_cfg(lib):
    # tests/test_parallel.py::test_sharded_lio_step_runs
    return lib("basic", {"trajectory_builder": {
        "scan_period": 0.1, "voxel_filter_size": 0.3, "enable_gravity_factor": False,
        "submaps": {"high_resolution": 0.2, "low_resolution": 0.5, "num_range_data": 3,
                    "high_resolution_extent": 64, "low_resolution_extent": 32},
        "max_raw_points": 1024, "max_filtered_points": 512,
        "max_high_res_points": 128, "max_low_res_points": 128,
        "max_imu_per_scan": 8, "window_size": 3, "gn_iterations": 2,
        "ceres_scan_matcher": {"max_num_iterations": 3},
    }}).trajectory_builder


def _lio_scans(batch, steps):
    rng = np.random.default_rng(0)
    return [JScan(time=np.full(batch, 0.1 * (k + 1), np.float32),
                  points=rng.uniform(-6, 6, (batch, 512, 3)).astype(np.float32),
                  times=np.zeros((batch, 512), np.float32), mask=np.ones((batch, 512), bool),
                  imu_dts=np.full((batch, 8), 0.01, np.float32),
                  imu_acc=np.tile(np.array([0.0, 0.0, G], np.float32), (batch, 8, 1)),
                  imu_gyr=np.zeros((batch, 8, 3), np.float32), imu_mask=np.ones((batch, 8), bool))
            for k in range(steps)]


def test_sharded_lio_step_matches_shards_and_jax():
    batch, steps = 2 * D, 3
    j_cfg, t_cfg = _lio_cfg(j_load_config), _lio_cfg(t_load_config)
    scans = _lio_scans(batch, steps)

    jmesh = _jax_mesh(D)
    jstate = JB.make_sharded_lio_state(j_cfg, batch, jmesh)
    tstates = TBatch.make_sharded_lio_state(t_cfg, batch, MESH)
    want = lio_state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    _equal_trees(gather(tstates, CPU), want, "initial state")
    jstep = JB.sharded_lio_step(j_cfg, batch, jmesh)
    tstep = TBatch.sharded_lio_step(t_cfg, batch, MESH)
    # each shard's lanes through the port's own batched step
    refs = [(TBatch.make_batched_lio_state(t_cfg, 2, CPU), TBatch.make_batched_lio_step(t_cfg, 2))
            for _ in range(D)]
    for k, scan in enumerate(scans):
        jstate, jres = jstep(jstate, JB.shard_over_mesh(jax.tree.map(jnp.asarray, scan), jmesh))
        tstates, tres = tstep(tstates, lio_scan_input_from_numpy(scan, CPU))
        for s, (ref_state, ref_step) in enumerate(refs):
            lanes = type(scan)(*(x[2 * s:2 * s + 2] for x in scan))
            ref_state, ref_res = ref_step(ref_state, lio_scan_input_from_numpy(lanes, CPU))
            refs[s] = (ref_state, ref_step)
            _equal_trees(tres[s], ref_res, f"step {k} shard {s} results")
            _equal_trees(tstates[s], ref_state, f"step {k} shard {s} state")
        jr, tr = jax.tree.map(np.asarray, jres), to_numpy(gather(tres, CPU))
        np.testing.assert_allclose(tr.scan.local_pose.translation, jr.scan.local_pose.translation,
                                   atol=POSE_ATOL, err_msg=f"step {k}")
        np.testing.assert_allclose(tr.scan.local_pose.rotation, jr.scan.local_pose.rotation,
                                   atol=POSE_ATOL, err_msg=f"step {k}")
        for f in ("inserted", "finished_submap", "insertion_submap_ids"):
            np.testing.assert_array_equal(getattr(tr.scan, f), getattr(jr.scan, f), err_msg=f"{f} {k}")
        assert np.isfinite(tr.scan.local_pose.translation).all()
    assert tstep.counts()["steps"] == D * steps
    js, ts = jax.tree.map(np.asarray, jstate), to_numpy(gather(tstates, CPU))
    np.testing.assert_array_equal(ts.frontend.submaps.lane, np.tile(np.arange(2), D))
    _assert_banks_equal(ts.frontend.submaps, js.frontend.submaps)
    np.testing.assert_array_equal(ts.frontend.submaps.num_created, js.frontend.submaps.num_created)
    np.testing.assert_allclose(ts.window.p, js.window.p, atol=POSE_ATOL)


# ----- (c) -----


def _frontend_step_case():
    batch = 2 * D
    j_cfg = _frontend_cfg_j()
    t_cfg = t_load_config("basic", {"trajectory_builder": {
        "min_range": 0.5, "max_range": 50.0, "voxel_filter_size": 0.2, "scan_period": 0.3,
        "ceres_scan_matcher": {"max_num_iterations": 6},
        "motion_filter": {"max_time_seconds": 0.0, "max_distance_meters": 0.0, "max_angle_radians": 0.0},
        "submaps": {"high_resolution": 0.25, "high_resolution_max_range": 50.0, "low_resolution": 0.8,
                    "num_range_data": 100, "high_resolution_extent": 96, "low_resolution_extent": 48},
        "max_filtered_points": 1024, "max_high_res_points": 512, "max_low_res_points": 512,
    }}).trajectory_builder
    offsets = [np.array([0.05 * b, 0.0, 0.0]) for b in range(batch)]
    jscan = _scan_batch(j_cfg, batch, offsets)
    # the same scan again 0.3 s later: the second step reads the first one's buffers
    jscans = [jscan, jscan._replace(time=jscan.time + 0.3)]
    return batch, j_cfg, t_cfg, jscans


def _port_scan(jscan):
    host = jax.tree.map(np.array, jscan)  # writable copies
    return ScanInput(time=torch.from_numpy(host.time), points=torch.from_numpy(host.points),
                     times=torch.from_numpy(host.times), mask=torch.from_numpy(host.mask),
                     relative_prediction=Rigid3(torch.from_numpy(host.relative_prediction.rotation),
                                                torch.from_numpy(host.relative_prediction.translation)))


def test_sharded_frontend_step_matches_jax(monkeypatch):
    """The compiled `sharded_step` (one `StepGraph` per shard) over two
    steps: each shard's state and results equal the eager `batched_step`
    from copies of the same pre-step state (integer state bit for bit),
    the gathered poses within POSE_ATOL of JAX's `sharded_step` and the
    banks bit for bit; then one more step of a shard's graph issues no
    op a capture refuses (tests/torch_capture_audit.py)."""
    batch, j_cfg, t_cfg, jscans = _frontend_step_case()
    jmesh = _jax_mesh(D)
    jstep = JB.sharded_step(j_cfg, jmesh)
    jstate = JB.shard_over_mesh(JB.make_batched_state(j_cfg, batch), jmesh)
    tstates = TBatch.shard_over_mesh(TBatch.make_batched_state(t_cfg, batch, CPU), MESH)
    assert all(s.submaps.lane.tolist() == [0, 1] for s in tstates)
    tstep = TBatch.sharded_step(t_cfg, MESH)
    eager = TBatch.batched_step(t_cfg)
    for k, jscan in enumerate(jscans):
        jstate, jres = jstep(jstate, JB.shard_over_mesh(jscan, jmesh))
        tscan = _port_scan(jscan)
        pre = [tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, st) for st in tstates]
        tstates, tres = tstep(tstates, tscan)
        for s_, piece in enumerate(shard_over_mesh(tscan, MESH)):
            want_state, want = eager(pre[s_], piece)
            _equal_trees(tstates[s_], want_state, f"step {k} shard {s_} state")
            _equal_trees(tres[s_], want, f"step {k} shard {s_} results")
        js, jr = jax.tree.map(np.asarray, jstate), jax.tree.map(np.asarray, jres)
        ts, tr = gather(tstates, CPU), gather(tres, CPU)
        np.testing.assert_allclose(tr.local_pose.translation.numpy(), jr.local_pose.translation, atol=POSE_ATOL,
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(tr.local_pose.rotation.numpy(), jr.local_pose.rotation, atol=POSE_ATOL,
                                   err_msg=f"step {k}")
        assert tr.inserted.all() and jr.inserted.all()
        for name in ("high_values", "low_values"):
            # the JAX package's (B, ·) per-lane banks
            np.testing.assert_array_equal(getattr(ts.submaps, name).numpy().reshape(batch, -1),
                                          getattr(js.submaps, name), err_msg=f"{name} {k}")
    assert tstep.counts() == {"steps": D * len(jscans), "warmups": 0, "captures": 0, "replays": 0}
    graph = tstep.steps[0]
    mode = audited(monkeypatch, graph.step)
    assert mode.ops > 1000 and not mode.found, dict(mode.found)


# ----- (d) -----


@pytest.fixture(scope="module")
def spa_problem():
    data, true_submaps, _ = _build_problem(np.random.default_rng(3))
    return data, true_submaps, to_torch(jax.tree.map(np.asarray, data), CPU)


def solve_atol(moved, scale):
    """The gate between two f32 solves of one problem (SOLVE_RTOL's comment)."""
    return SOLVE_RTOL * moved + SOLVE_ULPS * float(np.spacing(np.float32(scale)))


def _assert_poses_close(a, b, atol, what):
    for f in ("submap_q", "submap_t", "node_q", "node_t"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), atol=atol,
                                   rtol=0, err_msg=f"{what}: {f}")


@pytest.mark.parametrize("n_shards", [4, 3])
def test_sharded_solve(spa_problem, n_shards):
    data, true_submaps, tdata = spa_problem
    kw = dict(iterations=6, cg_iterations=48)
    mesh = Mesh((CPU,) * n_shards)
    whole = TO.solve(tdata, **kw)
    sharded = TO.solve(tdata, mesh=mesh, **kw)
    exact = TO.solve(TO.PoseGraphData(*(x.double() if x.is_floating_point() else x for x in tdata)), **kw)
    moved = float((exact.node_t - tdata.node_t.double()).abs().max())
    atol = solve_atol(moved, max(float(tdata.node_t.abs().max()), float(tdata.submap_t.abs().max())))
    _assert_poses_close(sharded, whole, atol, "sharded vs unsharded")
    for i, pose in enumerate(true_submaps):  # tests/test_parallel.py::test_sharded_spa_constraints
        assert float(np.linalg.norm(sharded.submap_t[i].numpy() - np.asarray(pose.translation))) < 0.05
    spread = _spread(tdata, n_shards)
    spread_sharded, spread_whole = TO.solve(spread, mesh=mesh, **kw), TO.solve(spread, **kw)
    _assert_poses_close(spread_sharded, spread_whole, atol, "spread rows")
    exact = exact._replace(**{f: getattr(exact, f).float() for f in ("submap_q", "submap_t", "node_q", "node_t")})
    for name, x in (("unsharded", whole), ("sharded", sharded), ("spread", spread_sharded),
                    ("spread unsharded", spread_whole)):  # solve_atol's premise
        _assert_poses_close(x, exact, atol / 2, f"{name} vs float64")
    jout = jax.jit(lambda d: JO.solve(d, mesh=_jax_mesh(n_shards, "c"), **kw))(data)
    _assert_poses_close(sharded, jax.tree.map(np.asarray, jout), JAX_SOLVE_ATOL, "port vs JAX sharded")


def _spread(tdata, n_shards):
    """The problem's rows permuted so that every shard holds valid ones."""
    perm = torch.from_numpy(np.random.default_rng(5).permutation(tdata.c_valid.shape[0]))
    spread = tdata._replace(**{f: getattr(tdata, f)[perm] for f in TO._C_FIELDS})
    per = -(-spread.c_valid.shape[0] // n_shards)
    assert all(bool(spread.c_valid[k * per:(k + 1) * per].any()) for k in range(n_shards))
    return spread


COMPILED_SOLVE_ITERATIONS = 2  # GN steps of the compiled sharded solves


@pytest.mark.parametrize("rows", ["contiguous", "spread"])
@pytest.mark.parametrize("n_shards", [4, 3])
def test_compiled_sharded_solve_equals_eager(spa_problem, n_shards, rows, monkeypatch):
    """The SPA's programs over a mesh (backend/pose_graph.py::_SpaPrograms,
    through `PoseGraph._solve`) equal the eager `solve(mesh=)` with the
    pose graph's settings exactly (the same ops in the same order), twice
    from one program set; then each program's step issues no op a capture
    refuses (tests/torch_capture_audit.py)."""
    _, _, tdata = spa_problem
    if rows == "spread":
        tdata = _spread(tdata, n_shards)
    mesh = Mesh((CPU,) * n_shards)
    tcfg = _port_config()
    pg = TPG.PoseGraph(tcfg.pose_graph, tcfg.trajectory_builder, device="cpu", mesh=mesh)
    problem = {k: v.numpy() for k, v in tdata._asdict().items()}
    blocks = TO.blocks_of(tdata)
    op = tcfg.pose_graph.optimization_problem
    want = pg._read_poses(TPG.spa_solve_eager(op, tdata, COMPILED_SOLVE_ITERATIONS, blocks, mesh))
    for _ in range(2):
        np.testing.assert_array_equal(pg._solve(problem, COMPILED_SOLVE_ITERATIONS, blocks), want)
    assert not np.array_equal(want, pg._read_poses(tdata))  # the solve moved the poses
    programs = pg.programs()
    assert {name: len(gs) for name, gs in programs.items()} == {
        "spa_rows": n_shards, "spa_jtj": n_shards, "spa_start": 1, "spa_cg": 1, "spa": 1}
    for gs in programs.values():
        for _, g in gs:
            mode = audited(monkeypatch, g.step)
            assert mode.ops > 5 and not mode.found, (g.name, dict(mode.found))


# ----- (e) -----


def _same_constraints(jpg, tpg):
    """tests/test_torch_pose_graph.py::_compare's constraint checks: the
    same (submap, node, tag) set, INTER relative poses within 0.05 m / 0.02."""
    key = lambda c: (c.submap_id, c.node_id, c.tag)  # noqa: E731
    assert sorted(map(key, tpg.constraints)) == sorted(map(key, jpg.constraints))
    jc = {key(c): c for c in jpg.constraints}
    for c in tpg.constraints:
        r = jc[key(c)].relative
        np.testing.assert_allclose(np.asarray(c.relative.translation), np.asarray(r.translation), atol=0.05)
        np.testing.assert_allclose(np.asarray(c.relative.rotation), np.asarray(r.rotation), atol=0.02)


def _recording(pg, log):
    search = pg._search

    def record(kind, hit, arrays):
        out = search(kind, hit, arrays)
        log.append((kind, tuple(a.shape for a in arrays), out.clone()))
        return out

    pg._search = record


def test_pose_graph_over_mesh():
    jcfg = _pg_cfg()
    tcfg = _port_config()
    whole = TPG.PoseGraph(tcfg.pose_graph, tcfg.trajectory_builder, device="cpu")
    meshed = TPG.PoseGraph(tcfg.pose_graph, tcfg.trajectory_builder, device="cpu", mesh=MESH)
    logs = ([], [])
    _recording(whole, logs[0])
    _recording(meshed, logs[1])
    for pg in (whole, meshed):
        _scenario(pg, jcfg, 2, [0.8, -0.5, 0.2], [4.0, 0.0, 0.0], finish_s1=False)
    assert logs[0] and len(logs[0]) == len(logs[1])
    for (k0, s0, o0), (k1, s1, o1) in zip(*logs):
        assert (k0, s0) == (k1, s1)
        assert torch.equal(o0, o1), (o0, o1)  # found, score, pose bit for bit
    inter = [c for c in meshed.constraints if c.tag == "INTER"]
    assert inter and inter[0].submap_id == 0
    np.testing.assert_allclose(np.asarray(inter[0].relative.translation), 0.0, atol=0.3)

    # one chunk of 5 nodes, split 2 / 2 / 1 / 0 over the shards
    hit = whole._decompressed_grids(0)
    node = whole.nodes[2]
    n = 5
    shifts = np.linspace(-0.3, 0.3, n).astype(np.float32)
    init_t = np.stack([np.asarray(node.global_pose.translation, np.float32) + [s, -s, 0.0] for s in shifts])
    arrays = (np.stack([node.high_points] * n).astype(np.float32), np.stack([node.high_mask] * n),
              np.stack([node.low_points] * n).astype(np.float32), np.stack([node.low_mask] * n),
              np.tile(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1)), init_t.astype(np.float32),
              np.stack([node.histogram] * n).astype(np.float32), np.zeros(n, np.float32),
              np.asarray(whole.submaps[0].histogram, np.float32))
    out_whole = whole._search("search_initial", hit, arrays)
    out_mesh = meshed._search("search_initial", hit, arrays)
    # found and score exact (each node's correlative search runs alone);
    # the refined pose through the batched GN of 2 or 1 nodes, not 5
    assert out_whole.shape == (n, 9) and torch.equal(out_whole[:, :2], out_mesh[:, :2])
    torch.testing.assert_close(out_mesh[:, 2:], out_whole[:, 2:], atol=PIECE_POSE_ATOL, rtol=0)
    assert bool((out_whole[:, 0] > 0.5).any())

    # the constraints against JAX's PoseGraph(mesh=) (the chunk above added
    # none); the final optimization over the mesh against the unsharded
    # port's, which tests/test_torch_pose_graph.py holds to JAX's
    jpg = JPoseGraph(jcfg.pose_graph, jcfg.trajectory_builder, mesh=_jax_mesh(D))
    _scenario(jpg, jcfg, 2, [0.8, -0.5, 0.2], [4.0, 0.0, 0.0], finish_s1=False)
    _same_constraints(jpg, meshed)
    before = np.stack([n.global_pose.translation for n in whole.nodes])
    for pg in (whole, meshed):
        pg.run_final_optimization()
    after = np.stack([n.global_pose.translation for n in whole.nodes])
    atol = solve_atol(float(np.abs(after - before).max()),
                      max(float(np.abs(after).max()), *(float(np.abs(s.global_pose.translation).max())
                                                         for s in whole.submaps)))
    for a, b in zip(whole.nodes, meshed.nodes):
        np.testing.assert_allclose(b.global_pose.translation, a.global_pose.translation, atol=atol, rtol=0)
    assert float(np.linalg.norm(meshed.nodes[2].global_pose.translation)) < 0.45 * float(
        np.linalg.norm([0.8, -0.5, 0.2]))  # tests/test_pose_graph.py:200-204

    cfg = t_load_config("basic", {"trajectory_builder": {"submaps": {"high_resolution_extent": 32,
                                                                      "low_resolution_extent": 16}}})
    assert MapBuilder(cfg, device="cpu", mesh=MESH).pose_graph.mesh is MESH


# ----- (f) -----


def _rtc(cfg):
    return dict(cfg, trajectory_builder=dict(
        cfg["trajectory_builder"], use_online_correlative_scan_matching=True,
        real_time_correlative_scan_matcher={"linear_search_window": 0.2, "max_angular_steps": 1}))


def test_batched_correlative_match_equals_each_lane():
    cfg = t_load_config("basic", _overrides(True)).trajectory_builder
    state = TBatch.make_batched_lio_state(cfg, 2, CPU)
    step = TBatch.make_batched_lio_step(cfg, 2)
    for scan in _scans(n_scans=2, start=2, seed=1):
        state, _ = step(state, lio_scan_input_from_numpy(scan, CPU))
    bank = state.frontend.submaps.high_brick
    bspec = brick_spec(cfg.submaps)
    rng = np.random.default_rng(7)
    pts = torch.from_numpy(rng.uniform(-5, 5, (2, 256, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, 256)) < 0.9)
    init = Rigid3(torch.tensor([[1.0, 0, 0, 0], [0.9998, 0.0, 0.0, 0.02]]),
                  torch.tensor([[0.05, -0.02, 0.0], [0.1, 0.0, -0.03]]))
    init = Rigid3(init.rotation / init.rotation.norm(dim=-1, keepdim=True), init.translation)
    slots = torch.tensor([0, 2], dtype=torch.int32)
    kw = dict(linear_search_window=0.2, angular_search_window=0.02, max_scan_range=10.0,
              max_angular_steps=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lanes = TR.match(init, pts, mask, bank, bspec, base=slots, **kw)
        for b in range(2):
            one = TR.match(Rigid3(init.rotation[b], init.translation[b]), pts[b], mask[b], bank, bspec,
                           base=slots[b], **kw)
            assert torch.equal(lanes.pose.rotation[b], one.pose.rotation)
            assert torch.equal(lanes.pose.translation[b], one.pose.translation)
            assert torch.equal(lanes.score[b], one.score) and torch.equal(lanes.index[b], one.index)


@pytest.fixture(scope="module")
def presearch():
    """The pre-search configs and JAX's batched step (one compile for both
    tests)."""
    j_cfg = j_load_config("basic", _rtc(_overrides(True))).trajectory_builder
    t_cfg = t_load_config("basic", _rtc(_overrides(True))).trajectory_builder
    assert t_cfg.use_online_correlative_scan_matching
    return j_cfg, t_cfg, JB.make_batched_lio_step(j_cfg, 2)


def test_batched_presearch_matches_jax(presearch):
    j_cfg, t_cfg, jstep = presearch
    jstate = JB.make_batched_lio_state(j_cfg, 2)
    tstate = TBatch.make_batched_lio_state(t_cfg, 2, CPU)
    tstep = TBatch.make_batched_lio_step(t_cfg, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for k, scan in enumerate(_scans(n_scans=PRESEARCH_SCANS, start=2, seed=1, empty_first=-1)):
            jstate, jres = jstep(jstate, jax.tree.map(jnp.asarray, scan))
            tstate, tres = tstep(tstate, lio_scan_input_from_numpy(scan, CPU))
            jr, tr = jax.tree.map(np.asarray, jres), to_numpy(tres)
            np.testing.assert_allclose(tr.scan.local_pose.translation, jr.scan.local_pose.translation,
                                       atol=POSE_ATOL, err_msg=f"scan {k}")
            np.testing.assert_allclose(tr.scan.local_pose.rotation, jr.scan.local_pose.rotation,
                                       atol=POSE_ATOL, err_msg=f"scan {k}")
            for f in ("inserted", "finished_submap", "matcher_iterations"):
                np.testing.assert_array_equal(getattr(tr.scan, f), getattr(jr.scan, f), err_msg=f"{f} {k}")
    _assert_banks_equal(to_numpy(tstate).frontend.submaps, jax.tree.map(np.asarray, jstate).frontend.submaps)


def test_batched_presearch_with_a_late_lane(presearch):
    j_cfg, t_cfg, jstep = presearch
    jstate = JB.make_batched_lio_state(j_cfg, 2)
    tstate = TBatch.make_batched_lio_state(t_cfg, 2, CPU)
    tstep = TBatch.make_batched_lio_step(t_cfg, 2)
    singles = [make_lio_state(t_cfg, NavState.identity(CPU), torch.zeros(3), torch.zeros(3)) for _ in range(2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for k, scan in enumerate(_scans(n_scans=PRESEARCH_SCANS, start=2, seed=1)):
            jstate, jres = jstep(jstate, jax.tree.map(jnp.asarray, scan))
            inp = lio_scan_input_from_numpy(scan, CPU)
            tstate, tres = tstep(tstate, inp)
            jr, tr = jax.tree.map(np.asarray, jres), to_numpy(tres)
            for f in ("inserted", "finished_submap", "matcher_iterations"):
                np.testing.assert_array_equal(getattr(tr.scan, f), getattr(jr.scan, f), err_msg=f"{f} {k}")
            lanes = (0, 1) if k < LATE_LANE_PARTS else (0,)
            for f in ("translation", "rotation"):
                np.testing.assert_allclose(getattr(tr.scan.local_pose, f)[list(lanes)],
                                           getattr(jr.scan.local_pose, f)[list(lanes)], atol=POSE_ATOL,
                                           err_msg=f"scan {k} {f}")
            if k < LATE_LANE_PARTS:
                _assert_banks_equal(to_numpy(tstate).frontend.submaps,
                                    jax.tree.map(np.asarray, jstate).frontend.submaps)
            for b in range(2):
                singles[b], one = lio_step(singles[b], _lane(inp, b), t_cfg)
                for f in ("translation", "rotation"):
                    torch.testing.assert_close(getattr(tres.scan.local_pose, f)[b],
                                               getattr(one.scan.local_pose, f), atol=LANE_ATOL, rtol=0)
    # lane 0's banks at the end, bit for bit
    want = lio_state_from_numpy(jax.tree.map(np.asarray, jstate), CPU).frontend.submaps
    got, want = TBatch.lane_banks(t_cfg, tstate.frontend.submaps, 0), TBatch.lane_banks(t_cfg, want, 0)
    for name in ("high_brick", "low_brick"):
        for f in ("directory", "pool", "counts", "group_of_slot", "dropped", "epochs"):
            assert torch.equal(getattr(got[name], f), getattr(want[name], f)), (name, f)

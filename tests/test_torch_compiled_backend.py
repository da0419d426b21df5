"""The backend's compiled programs (dliom_tpu_torch/backend/pose_graph.py:
decompress and pyramid, the with-initial and full-submap searches with
refinement, the submap image's projection, the image proposals and the
SPA's Gauss-Newton step; dliom_tpu_torch/imu/dynamic_initializer.py: the
NDT odometry) on the CPU, where `StepGraph` runs each body eagerly through
the same static buffers and copies that a CUDA graph replays on the card:

(a) after a warm-up call, each program issues no op that a CUDA graph
    capture refuses (tests/torch_capture_audit.py);
(b) the compiled search equals the eager search (`EagerPoseGraph`: the
    same body on fresh tensors) bit for bit, both kinds, for B = 1 ... the
    chunk size, with two chunks of the same B run before either is read:
    a result left on the graph's buffer would give the second chunk's
    answer twice; a whole loop search with proposals and the final
    optimization's solve gives the eager run's constraints and poses bit
    for bit; so does tools/torch_loop_recall.py's first trial, its
    proposals included;
(c) the SPA's programs (backend/pose_graph.py::_SpaPrograms, one shard)
    solving k GN steps equal `solve(iterations=k)` bit for bit, with and
    without the node-node, fixed-frame and landmark blocks;
(d) the compiled pose graph against the JAX `PoseGraph` on
    tests/test_torch_pose_graph.py's image-proposal scenario and tolerances (the same
    constraint set, INTER relative poses within 0.05 m / 0.02, final poses
    within 1e-3 m), every program of the scenario run through its graph;
    and the compiled NDT odometry against the JAX initializer's jitted
    `odom` (`build_field` + `ndt_match`) within tests/test_torch_ndt.py's
    1e-4 m and 1e-4 in quaternion components.

The scenario is tests/test_torch_pose_graph.py's image-proposal loop (128^3
/ 64^3 grids, depth 6), run once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_pose_graph as tpg_test
from dliom_tpu.backend.pose_graph import PoseGraph as JPoseGraph
from dliom_tpu.mapping.grid import GridSpec as JGridSpec
from dliom_tpu.ops import ndt as JN
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from dliom_tpu_torch.backend import optimization as TO
from dliom_tpu_torch.backend import pose_graph as TPG
from dliom_tpu_torch.backend.precomputation import Pyramid
from dliom_tpu_torch.imu.dynamic_initializer import DynamicInitializer
from dliom_tpu_torch.interop import to_torch
from dliom_tpu_torch.io.synthetic import SyntheticWorld
from dliom_tpu_torch.transform.rigid import Rigid3 as TRigid3
from test_optimization import _build_problem
from test_pose_graph import _cfg
import torch_threads  # noqa: F401  (one torch thread per test process)
from torch_capture_audit import audited

CPU = torch.device("cpu")
CHUNK = 4  # max_nodes_per_search_dispatch's default
POINTS = 64  # of each node's 1200 per cloud in the search cases: a full-submap search of all
# 1200 takes ~3 s on one CPU thread
SPA_PROGRAMS = ("spa_rows", "spa_jtj", "spa_start", "spa_cg", "spa")  # backend/pose_graph.py::_SpaPrograms
PROGRAMS = ("decompress", "project", "propose", "search_initial") + SPA_PROGRAMS


class EagerPoseGraph(TPG.PoseGraph):
    """The port's pose graph with every program's body run eagerly on fresh
    tensors: the reference the compiled programs are held to."""

    def _decompress(self, sub):
        fc_cfg = self.cfg.constraint_builder.fast_correlative_scan_matcher
        body = TPG.decompress_body(self._hi_spec, self._lo_spec, fc_cfg.branch_and_bound_depth,
                                   fc_cfg.full_resolution_depth)
        g_hi, g_lo, levels = body((), (sub.high.indices, sub.high.values, sub.low.indices, sub.low.values))[1]
        return g_hi, g_lo, Pyramid(levels=tuple(levels))

    def _search(self, kind, hit, arrays):
        g_hi, g_lo, pyr = hit
        body = TPG.search_body(kind, self.cfg.constraint_builder, self._hi_spec, self._lo_spec)
        return body((g_hi, g_lo, pyr.levels), [self._stage_array(a) for a in arrays])[1]

    def _project(self, hit):
        body = TPG.project_body(self._hi_spec, self.cfg.constraint_builder.image_proposal_size)
        return body((hit[0], hit[1], hit[2].levels), ())[1]

    def _propose(self, anchors, other, meters):
        body = TPG.propose_body(meters, self.cfg.constraint_builder.image_proposal_num_yaw)
        return self._host(body((), [self._stage_array(np.asarray(a, np.float32)) for a in (anchors, other)])[1])

    def _solve(self, problem, iterations, blocks):
        data = TO.PoseGraphData(**{k: self._stage_array(v) for k, v in problem.items()})
        return self._read_poses(TPG.spa_solve_eager(self.cfg.optimization_problem, data, iterations, blocks))


def _proposal_configs():
    jcfg = _cfg()
    jcfg = dataclasses.replace(jcfg, pose_graph=dataclasses.replace(
        jcfg.pose_graph, max_radius_enable_loop_detection=2.0,
        num_close_submaps_loop_with_initial_value=1, max_num_final_iterations=10))
    tcfg = tpg_test._port_config(max_radius_enable_loop_detection=2.0,
                                 num_close_submaps_loop_with_initial_value=1)
    return jcfg, tcfg


def _scenario(pg, jcfg):
    return tpg_test._scenario(pg, jcfg, 4, [6.0, -5.0, 0.1], [5.0, 0.0, 0.0], finish_s1=True)


@pytest.fixture(scope="module")
def graphs():
    """The image-proposal loop search through the JAX pose graph, the
    compiled port and the eager port, before the final optimization."""
    jcfg, tcfg = _proposal_configs()
    jpg = JPoseGraph(jcfg.pose_graph, jcfg.trajectory_builder)
    _scenario(jpg, jcfg)
    out = {"jax": jpg, "jcfg": jcfg}
    for name, cls in (("compiled", TPG.PoseGraph), ("eager", EagerPoseGraph)):
        pg = cls(tcfg.pose_graph, tcfg.trajectory_builder, device="cpu")
        _scenario(pg, jcfg)
        out[name] = pg
    return out


def _node_arrays(pg, kind, node_ids, shift):
    """A chunk's host arrays for `kind` from nodes of the scenario (the
    first POINTS of each cloud), each node's initial guess in submap 0
    moved by `shift` times its index in the chunk plus one (so each chunk
    and lane has its own answer)."""
    nodes = [pg.nodes[n] for n in node_ids]
    arrays = [np.stack([n.high_points[:POINTS] for n in nodes]).astype(np.float32),
              np.stack([n.high_mask[:POINTS] for n in nodes]).astype(bool),
              np.stack([n.low_points[:POINTS] for n in nodes]).astype(np.float32),
              np.stack([n.low_mask[:POINTS] for n in nodes]).astype(bool)]
    hist = np.stack([n.histogram for n in nodes]).astype(np.float32)
    submap_hist = np.asarray(pg.submaps[0].histogram, np.float32)
    if kind == "search_full":
        rots = np.stack([np.asarray(n.global_pose.rotation, np.float32) for n in nodes])
        return tuple(arrays + [rots, hist, submap_hist])
    q = np.stack([np.asarray(n.global_pose.rotation, np.float32) for n in nodes])
    t = np.stack([np.asarray(n.global_pose.translation, np.float32) + shift * (k + 1)
                  for k, n in enumerate(nodes)]).astype(np.float32)
    yaw = np.zeros(len(nodes), np.float32)
    return tuple(arrays + [q, t, hist, yaw, submap_hist])


@pytest.fixture(scope="module")
def searches(graphs):
    """For each kind and B = 1 ... CHUNK: two chunks searched compiled one
    after the other, then each read, beside the eager search of each."""
    pg = graphs["compiled"]
    hit = pg._decompressed_grids(0)
    out = {}
    for kind in TPG.SEARCH_KINDS:
        for b in range(1, CHUNK + 1):
            ids = [(2 + k) % len(pg.nodes) for k in range(b)]
            chunks = [_node_arrays(pg, kind, ids, np.asarray(s, np.float32))
                      for s in ((0.05, -0.03, 0.0), (-0.3, 0.2, 0.05))]
            got = [pg._search(kind, hit, c) for c in chunks]  # both queued, then read
            want = [EagerPoseGraph._search(pg, kind, hit, c) for c in chunks]
            out[kind, b] = (got, want)
    return out


# the programs' owner and the launch counters


def test_programs_belong_to_their_pose_graph(graphs):
    """A pose graph's programs are its own: a second pose graph on the same
    thread makes its own, and they are freed with the pose graph that made
    them (nothing keeps them for the thread or the process)."""
    import gc
    import weakref

    _, tcfg = _proposal_configs()
    pg = TPG.PoseGraph(tcfg.pose_graph, tcfg.trajectory_builder, device="cpu")
    images = np.random.default_rng(0).random((2, 32, 32)).astype(np.float32)
    pg._propose(images[:1], images[1], 0.2)
    prog = pg._programs()
    assert prog is not graphs["compiled"]._programs() and [g.name for _, g in pg.programs()["propose"]] == ["propose"]
    refs = [weakref.ref(prog), weakref.ref(prog.graphs[next(iter(prog.graphs))])]
    del pg, prog
    gc.collect()
    assert [r() for r in refs] == [None, None]


def test_launch_counters_from_many_threads():
    """Launches counted from many threads at once all count; a replay that
    adds an all-zero delta touches no counter."""
    import threading

    from dliom_tpu_torch.common import launches
    from dliom_tpu_torch.imu import affine_chain as ac

    before = ac.LAUNCHES

    def work():
        for _ in range(2000):
            launches.count(ac.__name__, "LAUNCHES")
            launches.add({f"{ac.__name__}.LAUNCHES": 0})

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ac.LAUNCHES == before + 8 * 2000
    ac.LAUNCHES = before
    launches.add({"not.a.module.COUNTER": 0})  # nothing is looked up


# (a) the audit


def test_backend_programs_issue_no_uncapturable_op(graphs, searches, monkeypatch):
    pg = graphs["compiled"]
    problem, _, _, blocks = pg._build_problem()
    pg._solve(problem, 1, blocks)  # the SPA graph's warm-up (the poses stay as they are)
    audited_names = set()
    for gs in pg.programs().values():
        for _, g in gs:
            assert g.steps >= 1, g.name
            mode = audited(monkeypatch, g.step)
            assert mode.ops > 5 and not mode.found, (g.name, dict(mode.found))
            audited_names.add(g.name)
    assert audited_names == set(PROGRAMS) | {"search_full"}


def test_ndt_odometry_issues_no_uncapturable_op(ndt_case, monkeypatch):
    g = ndt_case["graph"]
    assert g.steps >= 1
    mode = audited(monkeypatch, g.step)
    assert mode.ops > 1000 and not mode.found, dict(mode.found)


# (b) compiled search against eager


@pytest.mark.parametrize("b", range(1, CHUNK + 1))
@pytest.mark.parametrize("kind", TPG.SEARCH_KINDS)
def test_compiled_search_equals_eager(searches, kind, b):
    got, want = searches[kind, b]
    for k, (x, y) in enumerate(zip(got, want)):
        assert x.shape == (b, 9)
        assert torch.equal(x, y), (k, (x - y).abs().max())
    if kind == "search_initial":
        # the two chunks' answers differ, so a result left on the graph's
        # buffer would show
        assert not torch.equal(got[0], got[1])


def test_compiled_loop_search_and_solve_equal_eager(graphs):
    a, b = graphs["compiled"], graphs["eager"]
    key = lambda c: (c.submap_id, c.node_id, c.tag, c.score)  # noqa: E731
    assert [key(c) for c in a.constraints] == [key(c) for c in b.constraints]
    for x, y in zip(a.constraints, b.constraints):
        np.testing.assert_array_equal(x.relative.translation, y.relative.translation)
        np.testing.assert_array_equal(x.relative.rotation, y.relative.rotation)
    assert any(c.tag == "INTER" for c in a.constraints)
    # the final optimization's solve, its poses left unapplied
    (pa, _, _, blocks), (pb, _, _, _) = a._build_problem(), b._build_problem()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    iters = a.cfg.max_num_final_iterations
    np.testing.assert_array_equal(a._solve(pa, iters, blocks), b._solve(pb, iters, blocks))
    assert not b.programs()  # the eager pose graph made no program


def test_compiled_loop_recall_trial_equals_eager():
    """tools/torch_loop_recall.py's first trial (5 places, each submap its
    own grids) through the compiled programs and eagerly: the same
    proposals bit for bit (one, submap 0: the images kept per submap are
    copies, not the projection graph's buffer) and the same INTER
    constraints."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import torch_loop_recall as lr

    runs = []
    for cls in (TPG.PoseGraph, EagerPoseGraph):
        keep = {}
        real = lr.PoseGraph
        lr.PoseGraph = cls
        try:
            r = lr.run_trial(1000, device="cpu", keep=keep)
        finally:
            lr.PoseGraph = real
        runs.append((r, keep))
    (ra, a), (rb, b) = runs
    assert ra == rb and ra["precision"] == 1.0 and ra["recall"] == 1.0, (ra, rb)
    assert set(a["proposals"]) == set(b["proposals"]) == {0}
    for k, p in a["proposals"].items():
        q = b["proposals"][k]
        assert (p.yaw, p.score) == (q.yaw, q.score) and np.array_equal(p.shift_xy, q.shift_xy)
    inter = [[(c.submap_id, c.node_id, c.score, tuple(c.relative.translation)) for c in k["pg"].constraints
              if c.tag == "INTER"] for k in (a, b)]
    assert inter[0] == inter[1] and inter[0]
    assert a["pg"].graph_counts()["project"]["steps"] >= 5 and not b["pg"].programs()


# (c) the SPA graph's replays against solve


def _spa_problem(all_blocks):
    data, _, _ = _build_problem(np.random.default_rng(1), num_submaps=2, nodes_per_submap=4)
    d = to_torch(jax.tree.map(np.asarray, data), CPU)
    if not all_blocks:
        return d
    nn, ff, lm, lmp = (torch.zeros(n, dtype=torch.bool) for n in (1024, 256, 256, 64))
    nn[:3], ff[0], lm[:2], lmp[0] = True, True, True, True
    return d._replace(
        nn_first=torch.arange(1024, dtype=torch.int32) % 4,
        nn_second=torch.arange(1024, dtype=torch.int32) % 4 + 1,
        nn_trans_weight=torch.full((1024,), 10.0), nn_rot_weight=torch.full((1024,), 10.0), nn_valid=nn,
        ff_t=torch.ones(256, 3), ff_weight=torch.full((256,), 10.0), ff_valid=ff,
        lm_node2=torch.ones(256, dtype=torch.int32), lm_alpha=torch.full((256,), 0.3),
        lm_rel_t=torch.ones(256, 3), lm_trans_weight=torch.full((256,), 5.0),
        lm_rot_weight=torch.full((256,), 1.0), lm_valid=lm, lm_pos_valid=lmp,
        lm_positions=torch.zeros(64, 3).index_fill(0, torch.tensor([0]), 1.0))


@pytest.mark.parametrize("all_blocks", [False, True], ids=["spa_rows", "all_blocks"])
def test_spa_graph_replays_equal_solve(all_blocks):
    """The SPA's programs through `PoseGraph._solve` (one shard on the
    CPU): solves of k = 1 and 3 GN steps, one program set replayed for
    both, each equal to `solve(iterations=k)` bit for bit."""
    d = _spa_problem(all_blocks)
    blocks = TO.blocks_of(d)
    assert blocks == (all_blocks,) * 3
    cfg = tpg_test._port_config()
    op = dataclasses.replace(cfg.pose_graph.optimization_problem, huber_scale=1.0)
    pg = TPG.PoseGraph(dataclasses.replace(cfg.pose_graph, optimization_problem=op), cfg.trajectory_builder,
                       device="cpu")
    problem = {k: v.numpy() for k, v in d._asdict().items()}
    for k in (1, 3):
        got = pg._solve(problem, k, blocks)
        want = TPG.spa_solve_eager(op, d, k, blocks)
        np.testing.assert_array_equal(got, pg._read_poses(want), err_msg=f"{k} GN steps")
    assert not torch.equal(want.node_t, d.node_t)  # the solve moved the nodes
    assert [len(gs) for gs in pg.programs().values()] == [1] * len(SPA_PROGRAMS)
    assert pg.graph_counts()["spa"]["steps"] == 4 and pg.graph_counts()["spa_cg"]["steps"] == 4 * 64


# (d) parity with JAX


def test_compiled_pose_graph_matches_jax(graphs):
    """tests/test_torch_pose_graph.py::test_image_proposal_same_constraints
    through the compiled programs."""
    pg = graphs["compiled"]
    counts = pg.graph_counts()
    assert all(counts[p]["steps"] >= 1 for p in PROGRAMS if p not in SPA_PROGRAMS), counts
    tpg_test._compare(graphs["jax"], pg)
    assert pg.graph_counts()["spa"]["steps"] >= 1


@pytest.fixture(scope="module")
def ndt_case():
    """Two filtered synthetic scans 0.2 m apart, as the initializer
    prepares them, through the compiled odometry twice (the warm-up, then
    the step on the static buffers)."""
    world = SyntheticWorld.create()
    init = DynamicInitializer(tpg_test._port_config().trajectory_builder, "cpu")
    clouds = []
    for t in ((0.0, 0.0, 0.0), (0.2, 0.08, 0.0)):
        pose = TRigid3(np.asarray([1.0, 0, 0, 0], np.float32), np.asarray(t, np.float32))
        clouds.append(init._prep(world.cast_scan(pose)[0]))
    q0 = torch.tensor([np.cos(0.01), 0.0, 0.0, np.sin(0.01)], dtype=torch.float32)
    t0 = torch.tensor([0.05, 0.0, 0.01])
    guess = TRigid3(q0, t0)
    first = init._odometry(clouds[0], clouds[1], guess)
    second = init._odometry(clouds[0], clouds[1], guess)
    return {"graph": init.odometry_graph, "clouds": clouds, "guess": guess, "rel": (first, second)}


def test_compiled_ndt_matches_jax_odom(ndt_case):
    first, second = ndt_case["rel"]
    assert torch.equal(first.rotation, second.rotation) and torch.equal(first.translation, second.translation)
    last, cur = ndt_case["clouds"]
    spec = JGridSpec(1.0, DynamicInitializer.ODOM_SPEC.extent)

    @jax.jit
    def odom(last_pts, last_mask, cur_pts, cur_mask, init_q, init_t):  # dliom_tpu dynamic_initializer.py:106
        field = JN.build_field(last_pts, last_mask, spec)
        return JN.match(field, spec, cur_pts, cur_mask, JRigid3(init_q, init_t))

    g = ndt_case["guess"]
    want = odom(*(jnp.asarray(x.numpy()) for x in (last.points, last.mask, cur.points, cur.mask,
                                                    g.rotation, g.translation)))
    np.testing.assert_allclose(first.translation.numpy(), np.asarray(want.translation), atol=1e-4)
    np.testing.assert_allclose(first.rotation.numpy(), np.asarray(want.rotation), atol=1e-4)
    np.testing.assert_allclose(first.translation.numpy(), [0.2, 0.08, 0.0], atol=0.03)

"""Global SLAM: pose-graph orchestration (port of
dliom_tpu/backend/pose_graph.py; reference PoseGraph3D + ConstraintBuilder3D,
pose_graph_3d.cc and constraint_builder_3d.cc).

A host orchestrator keeps node and submap bookkeeping in numpy (float64)
and runs three kinds of device work on `device`: decompression and the
max-pool pyramid of finished submaps, the loop search (correlative matcher
then batched GN refinement), and the matrix-free SPA solve. INTRA
constraints come from insertion; INTER constraints from the close-submap
search with initial value, the submap-image proposals (FFT-NCC) for
high-drift loops, and the whole-submap global search across unconnected
trajectories.

Threads. With a native `TaskThreadPool`, searches and the periodic SPA run
as pool tasks. On CUDA each task sets the device, runs on its own stream
of its worker thread, first waits for an event recorded on the submitting
stream (so it sees the captured submap grids), marks borrowed tensors with
`record_stream`, and synchronizes its stream before it ends. The port
departs from the JAX package on purpose in three places:
  * the SPA write-back and the extrapolation of poses added during the
    solve hold `_mutex`, as does `add_node`'s seeding of global poses;
  * `_opt_pending` is checked and set under a lock;
  * a submap's decompression is guarded in flight: a second worker waits
    for the first one's grids instead of decompressing again.

Mesh (`mesh=`, a `common/mesh.py::Mesh`; dliom_tpu/backend/pose_graph.py
:141-147, :617-640). A search chunk's node batch is split into contiguous
pieces over the mesh's shards (a chunk smaller than D leaves shards idle;
no node is padded in): each shard runs its own search program on its
device, against the target submap's cached grids and pyramid copied once
into that device's static grids, and the packed results are gathered on
`device` before the chunk's one host read. Every shard's program is
queued before any result is gathered. The SPA's constraint rows are
split over the shards, each shard's programs on its device, the partial
sums added on the first device (`_SpaPrograms`). Decompression,
projection and proposals stay on `device`. A pool task sets a stream of
its worker thread on every device of the mesh and drains them all before
it ends.

Compiled programs. The JAX package jits the search's programs and the SPA
solve; here each is a `common/graph.py::StepGraph` (on the card one eager
warm-up, one CUDA graph capture, then a replay per call; on the CPU the same
buffers run eagerly). The pose graph owns them, and they go with it:
  * per thread that searches (`_Programs`: a pool worker, or the caller's
    thread where there is no pool): decompress and pyramid, one graph per
    compressed shape; the searches with refinement, one graph per kind
    (with-initial, full-submap) and chunk shape; the projection of a submap
    image; the image proposals, one graph per candidate count. Their graphs
    share one memory pool (`SharedPool`), since one thread replays them one
    after another. The searches and the projection read one set of static
    grids per thread, into which the cached grids of the target submap are
    copied; a graph's result is its buffer, so what is kept (the grid
    cache's entries, a chunk's packed result) is copied off it before the
    next replay is queued. A submap query's projection (`submap_query`, on
    whatever thread asks) runs eagerly and makes no program;
  * per problem shape, blocks and mesh (one path: without a mesh, a
    single shard on `device`): the SPA's programs (`_SpaPrograms`), the
    rows and J^T J p per shard, the CG's start, its step and the pose
    update on the first device, ordered by stream events and replayed
    64 x (D + 1) + D + 2 times a GN step, under a lock held for a whole
    solve: the periodic solve runs on a pool thread, the final one on the
    caller's thread, never at once, and a solve ends with its host read,
    so the next one, on whatever streams, starts after it.
The bodies (`decompress_body`, `search_body`, `project_body`,
`propose_body`; the SPA's in `backend/optimization.py`) are module
functions: run eagerly on fresh tensors, they are what the programs are
held to (`spa_solve_eager` for the SPA).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from dliom_tpu_torch.backend import fast_correlative as fc
from dliom_tpu_torch.backend import optimization as opt
from dliom_tpu_torch.backend.compression import CompressedGrid, compress, decompress
from dliom_tpu_torch.backend.precomputation import Pyramid, build_pyramid
from dliom_tpu_torch.backend.submap_projection import (
    SubmapImage,
    keep_fft_plans,
    meters_per_pixel,
    project_to_image,
    propose_2d_transform,
    proposal_to_initial_guess,
)
from dliom_tpu_torch.common import mesh as _mesh
from dliom_tpu_torch.common.config import (
    ConstraintBuilderConfig,
    OptimizationProblemConfig,
    PoseGraphConfig,
    TrajectoryBuilderConfig,
)
from dliom_tpu_torch.common.device import get_device
from dliom_tpu_torch.common.graph import SharedPool, StepGraph, sum_counts
from dliom_tpu_torch.common.mesh import Mesh, indexed, split_sizes
from dliom_tpu_torch.mapping.grid import GridSpec
from dliom_tpu_torch.mapping.submap import grid_specs
from dliom_tpu_torch.ops.rotational_histogram import np_rotate_histogram
from dliom_tpu_torch.ops.scan_matcher import match_batch as gn_match_batch
from dliom_tpu_torch.transform.rigid import (
    Rigid3,
    np_compose,
    np_inverse,
    np_quat_conjugate,
    np_quat_multiply,
    np_quat_rotate,
    np_quat_yaw,
    np_rigid,
)

_LOG = logging.getLogger("dliom_tpu_torch.pose_graph")


@dataclass
class NodeRecord:
    """TrajectoryNode (trajectory_node.h): constant data (host numpy) and
    poses. Ids are global flat ints; `trajectory_id` is the other half of
    the reference's NodeId."""

    time: float
    local_pose: Rigid3  # in the local (frontend) frame
    gravity_alignment: np.ndarray  # (4,)
    high_points: np.ndarray  # (Nh, 3) in the tracking frame
    high_mask: np.ndarray
    low_points: np.ndarray
    low_mask: np.ndarray
    histogram: np.ndarray  # (H,)
    submap_ids: Tuple[int, ...]  # submaps this node was inserted into
    global_pose: Rigid3 = None  # optimized
    frozen: bool = False
    trajectory_id: int = 0


@dataclass
class SubmapRecord:
    local_pose: Rigid3  # frontend frame
    global_pose: Rigid3
    high: Optional[CompressedGrid] = None  # set when finished (device tensors)
    low: Optional[CompressedGrid] = None
    histogram: Optional[np.ndarray] = None  # accumulated node histograms
    node_ids: List[int] = field(default_factory=list)
    finished: bool = False
    image: Optional[SubmapImage] = None  # top-down projection, host numpy
    frozen: bool = False
    trimmed: bool = False
    trajectory_id: int = 0
    index_in_trajectory: int = 0


@dataclass
class Constraint:
    submap_id: int
    node_id: int
    relative: Rigid3  # node in the submap frame
    translation_weight: float
    rotation_weight: float
    tag: str  # "INTRA" | "INTER"
    score: float = 1.0
    yaw_correction: float = 0.0  # INTER: yaw moved from the initial guess (rad)


# ----- compiled programs (see the module docstring) -----

SEARCH_KINDS = ("search_initial", "search_full")
_POSE_FIELDS = ("submap_q", "submap_t", "node_q", "node_t", "lm_positions", "lm_q")


def _grid_leaves(grids):
    """The static grids' tensors: (g_hi, g_lo, pyramid levels)."""
    g_hi, g_lo, levels = grids
    return (g_hi, g_lo, *levels)


class _Programs:
    """One thread's compiled search programs of a pose graph on one device:
    the graphs by key, the memory pool they share, and the static grids the
    searches and the projection read."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graphs: Dict[tuple, StepGraph] = {}
        self.pool = SharedPool()
        self.grids = None  # (g_hi, g_lo, levels)
        self.loaded = None  # the cached grids now copied into them

    def graph(self, key: tuple, name: str, body, adopt=lambda s: ()) -> StepGraph:
        """The graph of `key`, made of `body()` at its first call."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = StepGraph(body(), adopt=adopt, pool=self.pool, name=name)
        return g

    def load_grids(self, hit) -> None:
        """Copy a submap's cached (g_hi, g_lo, pyramid) into the static
        grids on this set's device, unless they hold them already."""
        g_hi, g_lo, pyr = hit
        if self.grids is None:
            self.grids = (g_hi.to(self.device, copy=True), g_lo.to(self.device, copy=True),
                          tuple(x.to(self.device, copy=True) for x in pyr.levels))
        elif self.loaded is not hit:
            for s, x in zip(_grid_leaves(self.grids), (g_hi, g_lo, *pyr.levels)):
                s.copy_(x)
        self.loaded = hit


def _refine(cb: ConstraintBuilderConfig, specs, poses: Rigid3, g_hi, g_lo, hp, hm, lp, lm):
    loop_cfg = cb.ceres_scan_matcher
    return gn_match_batch(
        poses, clouds=[(hp, hm), (lp, lm)], grids=[g_hi, g_lo], specs=list(specs),
        occupied_space_weights=[loop_cfg.occupied_space_weight_0, loop_cfg.occupied_space_weight_1],
        translation_weight=loop_cfg.translation_weight,
        rotation_weight=loop_cfg.rotation_weight,
        only_optimize_yaw=loop_cfg.only_optimize_yaw,
        max_iterations=loop_cfg.max_num_iterations,
        function_tolerance=loop_cfg.function_tolerance,
    )


def _refine_and_pack(cb, specs, res, g_hi, g_lo, hp, hm, lp, lm) -> torch.Tensor:
    """The batched GN refinement of the correlative results, packed (B, 9):
    found, score, refined rotation (4), refined translation (3)."""
    poses = Rigid3(torch.stack([r.pose.rotation for r in res]),
                   torch.stack([r.pose.translation for r in res]))
    refined = _refine(cb, specs, poses, g_hi, g_lo, hp, hm, lp, lm)
    found = torch.stack([r.found for r in res]).to(torch.float32)
    score = torch.stack([r.score for r in res])
    return torch.cat([found[:, None], score[:, None], refined.pose.rotation,
                      refined.pose.translation], dim=1)


def search_body(kind: str, cb: ConstraintBuilderConfig, hi_spec: GridSpec, lo_spec: GridSpec):
    """`body(grids, inp) -> (grids, packed)` of one chunk's search program:
    the correlative match of each of the B nodes in turn (as the eager
    search does), then the batched GN refinement of all of them. `grids` is
    (g_hi, g_lo, pyramid levels); `inp` the chunk's (B, ...) node arrays
    and the submap histogram: high points, mask, low points, mask, then for
    "search_initial" the initial rotation and translation, the histogram
    and the initial yaw, for "search_full" the rotation guess and the
    histogram."""
    specs = (hi_spec, lo_spec)
    if kind == "search_initial":
        fc_cfg = cb.fast_correlative_scan_matcher
        n_yaw = int(cb.with_initial_num_yaw_candidates)
        if n_yaw > 1:
            fc_cfg = dataclasses.replace(fc_cfg, angular_search_window=float(cb.with_initial_yaw_window))

        def body(grids, inp):
            g_hi, g_lo, levels = grids
            pyr = Pyramid(levels=tuple(levels))
            hp, hm, lp, lm, initial_q, initial_t, hist, yaw0, submap_hist = inp
            res = [fc.match(pyr, hi_spec, g_lo, lo_spec, hp[i], hm[i], lp[i], lm[i],
                            Rigid3(initial_q[i], initial_t[i]), hist[i], submap_hist, yaw0[i],
                            fc_cfg, float(cb.min_score), num_angles=n_yaw, use_rotational_gate=False,
                            beam_width=160, coarse_point_stride=int(cb.coarse_scoring_stride))
                   for i in range(hp.shape[0])]
            return grids, _refine_and_pack(cb, specs, res, g_hi, g_lo, hp, hm, lp, lm)
    elif kind == "search_full":
        def body(grids, inp):
            g_hi, g_lo, levels = grids
            pyr = Pyramid(levels=tuple(levels))
            hp, hm, lp, lm, rot, hist, submap_hist = inp
            res = [fc.match_full_submap(pyr, hi_spec, g_lo, lo_spec, hp[i], hm[i], lp[i], lm[i],
                                        rot[i], hist[i], submap_hist, cb.fast_correlative_scan_matcher,
                                        float(cb.global_localization_min_score), beam_width=1024,
                                        coarse_point_stride=int(cb.coarse_scoring_stride))
                   for i in range(hp.shape[0])]
            return grids, _refine_and_pack(cb, specs, res, g_hi, g_lo, hp, hm, lp, lm)
    else:
        raise ValueError(f"search kind {kind!r} is not one of {SEARCH_KINDS}")
    return body


def decompress_body(hi_spec: GridSpec, lo_spec: GridSpec, depth: int, full_resolution_depth: int):
    """`body((), (hi indices, hi values, lo indices, lo values)) -> ((),
    (g_hi, g_lo, pyramid levels))`: a finished submap's dense grids and the
    max-pool pyramid of its high grid."""
    def body(state, inp):
        hi_idx, hi_val, lo_idx, lo_val = inp
        g_hi = decompress(CompressedGrid(hi_idx, hi_val, None), hi_spec)
        g_lo = decompress(CompressedGrid(lo_idx, lo_val, None), lo_spec)
        pyr = build_pyramid(g_hi, hi_spec, depth=depth, full_resolution_depth=full_resolution_depth)
        return state, (g_hi, g_lo, pyr.levels)
    return body


def project_body(spec: GridSpec, size: int):
    """`body(grids, ()) -> (grids, image)`: the top-down image of the
    static high grid."""
    def body(grids, inp):
        return grids, project_to_image(grids[0], spec, size).image
    return body


def propose_body(meters: float, num_yaw: int):
    """`body((), (anchors (n, S, S), other (S, S))) -> ((), (n, 4))`: per
    anchor image, the proposal (yaw, shift x, shift y, score) aligning
    `other` onto it."""
    def body(state, inp):
        anchors, other = inp
        b = SubmapImage(other, meters)
        rows = []
        for i in range(anchors.shape[0]):
            p = propose_2d_transform(SubmapImage(anchors[i], meters), b, num_yaw=num_yaw)
            rows.append(torch.stack([p.yaw, p.shift_xy[0], p.shift_xy[1], p.score]))
        return state, torch.stack(rows)
    return body


def _spa_settings(op: OptimizationProblemConfig, blocks) -> dict:
    """The pose graph's `optimization.gn_step` / `solve` settings."""
    return dict(cg_iterations=64, fix_first_submap=False, ff_huber_scale=float(op.huber_scale),
                inter_huber_scale=float(op.huber_scale) if op.use_inter_huber else 0.0, blocks=blocks)


def spa_solve_eager(op: OptimizationProblemConfig, problem: opt.PoseGraphData, iterations: int, blocks,
                    mesh: Optional[Mesh] = None):
    """`optimization.solve` with the pose graph's settings, eagerly: only
    the reference that the SPA programs' replays are held to (the pose
    graph's solve runs `_SpaPrograms`, with or without a mesh)."""
    return opt.solve(problem, iterations=iterations, mesh=mesh, **_spa_settings(op, blocks))


def _with_poses(problem: opt.PoseGraphData, poses) -> opt.PoseGraphData:
    return problem._replace(**dict(zip(_POSE_FIELDS, poses)))


def _like(tree, device: torch.device):
    """New tensors of the tree's shapes and types on `device`."""
    return tree_map(lambda x: torch.empty_like(x, device=device), tree)


class _SpaPrograms:
    """The SPA solve of one problem shape and blocks over one mesh (a
    single shard on the pose graph's device without one) as compiled
    programs, the bodies of `optimization.gn_step` each a `StepGraph`:
      * per shard, on its device: (a) "spa_rows" (`spa_rows`; its input,
        the shard's constraint rows and the replicated poses and flags,
        staged from the host in one copy per solve) and (b) "spa_jtj"
        (`spa_jtj` of the direction in its input; its state, (a)'s rows,
        adopted);
      * on the first device: "spa_start" (`cg_start`), (c) "spa_cg"
        (`cg_update`; its state, spa_start's result, adopted) and (d)
        "spa" (`pose_update`: one step a GN step; its state, the solve's
        poses; its input, the whole problem, staged in one copy per
        solve). The first device's programs read the problem and the
        poses from spa's buffers.
    A GN step: spa's poses copied out to every (a)'s input (from the second
    GN step on), each (a), their partials copied in, spa_start; per CG step
    the direction copied out, each (b), their partials copied in, (c);
    then (d). The copies between the first device and the shards are
    ordered by stream events (`common/mesh.py::copy_out`, `copy_in`) on the
    calling thread's current stream of each device, never by the host:
    the devices run their shards at once, and the host reads only the
    solve's result. Shards that share a device take the same programs and
    events. The graphs of a device share one memory pool (a `SharedPool`):
    one thread at a time runs a solve (under `lock`), and a solve ends with
    its host read, so the next one, on whatever streams, starts after it."""

    def __init__(self, op: OptimizationProblemConfig, blocks, mesh: Mesh):
        kw = _spa_settings(op, blocks)
        fix, huber = kw["fix_first_submap"], kw["inter_huber_scale"]
        cg_kw = dict(ff_huber_scale=kw["ff_huber_scale"], blocks=blocks)
        self.mesh, self.cg_iterations, self.lock = mesh, kw["cg_iterations"], threading.Lock()
        pools = {d: SharedPool() for d in mesh.distinct_devices}
        first = pools[mesh.first]

        def rows_body(state, shard):
            return state, opt.spa_rows(shard, fix, huber)

        def jtj_body(rows, v):
            return rows, opt.spa_jtj(rows, *v)

        def start_body(state, partials):
            return state, opt.cg_start(self.problem(), partials, fix_first_submap=fix, **cg_kw)

        def cg_body(carry, partials):
            return opt.cg_update(self.problem(), carry, partials, **cg_kw), None

        def update_body(poses, problem):
            d = opt.pose_update(_with_poses(problem, poses), self.start.result)
            return tuple(getattr(d, f) for f in _POSE_FIELDS), None

        self.rows = [StepGraph(rows_body, pool=pools[d], name="spa_rows") for d in mesh.devices]
        self.jtj = [StepGraph(jtj_body, adopt=tree_leaves, pool=pools[d], name="spa_jtj") for d in mesh.devices]
        self.start = StepGraph(start_body, pool=first, name="spa_start")
        self.cg = StepGraph(cg_body, adopt=tree_leaves, pool=first, name="spa_cg")
        self.update = StepGraph(update_body, pool=first, name="spa")

    def graphs(self) -> List[StepGraph]:
        return [*self.rows, *self.jtj, self.start, self.cg, self.update]

    def problem(self) -> opt.PoseGraphData:
        """The problem at the solve's current poses, on the first device (spa's buffers)."""
        return _with_poses(self.update.inp, self.update.state)

    def solve(self, problem: Dict[str, np.ndarray], iterations: int) -> opt.PoseGraphData:
        """`iterations` GN steps from the host problem; the result is
        `problem()`, the graphs' buffers."""
        mesh = self.mesh
        host = opt.PoseGraphData(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in problem.items()})
        replicated = {f: getattr(host, f) for f in opt._REPLICATED}
        shards = [[x.numpy() for x in {**rows, **replicated}.values()]  # SHARD_FIELDS' order
                  for rows in opt.shard_constraints(host, Mesh((torch.device("cpu"),) * mesh.size))]
        if self.update.state is None:
            d = opt.PoseGraphData(*(x.to(mesh.first) for x in host))
            self.update.bind(tuple(getattr(d, f) for f in _POSE_FIELDS), d)
            for g, dev, arrays in zip(self.rows, mesh.devices, shards):
                g.bind((), {f: torch.from_numpy(a).to(dev) for f, a in zip(opt.SHARD_FIELDS, arrays)})
        for g, arrays in zip(self.rows, shards):
            g.stage_input(arrays)  # a shard's rows (padded) and the replicated fields: one copy to its device
        self.update.stage_input(list(problem.values()))  # one copy to the first device
        self.update.load_state(tuple(getattr(self.update.inp, f) for f in _POSE_FIELDS))
        for it in range(iterations):
            self._gn_step(copy_poses=it > 0)
        return self.problem()

    def _gn_step(self, copy_poses: bool) -> None:
        mesh, first = self.mesh, self.mesh.first
        if copy_poses:
            _mesh.copy_out(self.update.state[:len(opt._POSES)],
                           [[g.inp[f] for f in opt._POSES] for g in self.rows], mesh)
        for g in self.rows:
            g.step()
        if self.start.state is None:
            self.start.bind((), [_like(g.result[1], first) for g in self.rows])
        _mesh.copy_in([g.result[1] for g in self.rows], self.start.inp, mesh)
        self.start.step()
        direction = self.start.result.p[:2]  # spa_cg's state: its steps rewrite it
        for _ in range(self.cg_iterations):
            if self.jtj[0].state is None:
                for g, rows, dev in zip(self.jtj, self.rows, mesh.devices):
                    g.bind(rows.result[0], _like(direction, dev))
            _mesh.copy_out(direction, [g.inp for g in self.jtj], mesh)
            for g in self.jtj:
                g.step()
            if self.cg.state is None:
                self.cg.bind(self.start.result, [_like(g.result, first) for g in self.jtj])
            _mesh.copy_in([g.result for g in self.jtj], self.cg.inp, mesh)
            self.cg.step()
        self.update.step()


class PoseGraph:
    """Host orchestrator (PoseGraph3D API surface)."""

    def __init__(self, cfg: PoseGraphConfig, tb_cfg: TrajectoryBuilderConfig, pool=None,
                 metrics=None, device=None, mesh: Optional[Mesh] = None):
        """`pool`: optional native TaskThreadPool; loop searches and the
        periodic SPA then run as background tasks. `device`: where the
        search and solve run: the CUDA card by default (raises where there is
        none), "cpu" on request. `mesh`: the search's node batches and the
        SPA's constraint rows split over its devices (module docstring),
        which are of `device`'s type."""
        self.cfg = cfg
        self.tb_cfg = tb_cfg
        self.device = get_device("cuda" if device is None else device)
        if mesh is not None and any(d.type != self.device.type for d in mesh.devices):
            raise ValueError(f"{mesh} is not of the pose graph's device type {self.device.type}")
        self.mesh = mesh
        self.nodes: List[NodeRecord] = []
        self.submaps: List[SubmapRecord] = []
        self.constraints: List[Constraint] = []
        self._constraint_index: set = set()
        self._trajectory_states: Dict[int, str] = {}
        self._traj_submap_counts: Dict[int, int] = {}
        self._conn_parent: Dict[int, int] = {}
        self._last_connection: Dict[Tuple[int, int], float] = {}
        self._nodes_since_optimization = 0
        self._opt_pending = False
        self._opt_lock = threading.Lock()
        self._num_histogram = tb_cfg.rotational_histogram_size
        self._hi_spec, self._lo_spec = grid_specs(tb_cfg.submaps)
        self._compress_capacity = 1 << 18
        self._pool = pool
        self._mutex = threading.Lock()
        self._metrics = metrics
        self.fixed_frame_observations: List[Tuple[int, np.ndarray, float]] = []
        self.landmark_observations: List[Tuple] = []
        self._landmark_ids: Dict[str, int] = {}
        self.odometry_links: List[Tuple[int, int, Rigid3]] = []
        self.constraint_search_seconds: List[float] = []
        self.phase_seconds: Dict[str, float] = collections.defaultdict(float)
        self._phase_lock = threading.Lock()
        self._grid_cache: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()
        self._grid_inflight: Dict[int, threading.Event] = {}
        # (thread id, device) -> the worker's stream on that device
        self._streams: Dict[Tuple[int, torch.device], torch.cuda.Stream] = {}
        self._last_landmark_positions = None
        self._programs_by_thread: Dict[Tuple[int, torch.device], _Programs] = {}
        self._spa_graphs: Dict[tuple, _SpaPrograms] = {}
        self._programs_lock = threading.Lock()

    def _phase(self, name: str, seconds: float) -> None:
        with self._phase_lock:
            self.phase_seconds[name] += seconds

    # ----- device and threads -----

    def _on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def _borrow(self, *tensors) -> None:
        """Mark tensors made on another stream as used by the current one."""
        if self._on_cuda():
            stream = torch.cuda.current_stream(self.device)
            for t in tensors:
                t.record_stream(stream)

    def _devices(self) -> Tuple[torch.device, ...]:
        """`device`, then the mesh's other devices."""
        return tuple(dict.fromkeys((indexed(self.device),) + (self.mesh.devices if self.mesh else ())))

    def _device_task(self, fn):
        """Wrap a pool task: on CUDA it runs on its worker thread's own
        stream of each device (`device` and the mesh's), after everything
        the submitting stream has queued so far, and its streams are
        drained before it returns."""
        if not self._on_cuda():
            return fn
        dev = self.device
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))

        def run():
            # keyed by thread id: a native worker's threading.local is new
            # for every task
            tid = threading.get_ident()
            with self._phase_lock:
                for d in self._devices():
                    if (tid, d) not in self._streams:
                        self._streams[(tid, d)] = torch.cuda.Stream(d)
                streams = [self._streams[(tid, d)] for d in self._devices()]
            # a stream context makes its stream's device current: `device`'s
            # goes last
            with torch.cuda.device(dev), contextlib.ExitStack() as stack:
                for stream in reversed(streams):
                    stack.enter_context(torch.cuda.stream(stream))
                streams[0].wait_event(ready)
                try:
                    fn()
                finally:
                    for stream in streams:
                        stream.synchronize()

        return run

    def _add_task(self, fn) -> None:
        self._pool.add_task(self._device_task(fn))

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """A host copy of `t` (never a view: on the CPU a program's result
        is its buffer, which the next call rewrites)."""
        return t.detach().to("cpu", copy=True).numpy()

    def _decompressed_grids(self, to_id: int):
        """(g_hi, g_lo, pyramid) of a finished submap, LRU-cached on the
        device (PrecomputationGridStack3D reuse). A submap being decompressed
        by one worker is waited for, not decompressed again."""
        while True:
            with self._phase_lock:
                hit = self._grid_cache.get(to_id)
                if hit is not None:
                    self._grid_cache.move_to_end(to_id)
                    break
                inflight = self._grid_inflight.get(to_id)
                owner = inflight is None
                if owner:
                    inflight = self._grid_inflight[to_id] = threading.Event()
            if not owner:
                inflight.wait()
                continue
            try:
                t0 = _time.perf_counter()
                sub = self.submaps[to_id]
                self._borrow(*sub.high, *sub.low)
                hit = self._decompress(sub)
                if self._on_cuda():
                    torch.cuda.current_stream(self.device).synchronize()
                self._phase("search_decompress", _time.perf_counter() - t0)
                with self._phase_lock:
                    self._grid_cache[to_id] = hit
                    while len(self._grid_cache) > max(1, self.cfg.grid_cache_size):
                        self._grid_cache.popitem(last=False)
            finally:
                with self._phase_lock:
                    self._grid_inflight.pop(to_id).set()
            return hit
        g_hi, g_lo, pyr = hit
        self._borrow(g_hi, g_lo, *pyr.levels)
        return hit

    @property
    def low_compress_capacity(self) -> int:
        """Sparse-cell capacity of low-resolution submap grids."""
        return self._compress_capacity // 4

    # ----- trajectory lifecycle -----

    def add_trajectory(self, frozen: bool = False) -> int:
        tid = len(self._trajectory_states)
        self._trajectory_states[tid] = "FROZEN" if frozen else "ACTIVE"
        self._traj_submap_counts[tid] = 0
        self._conn_parent[tid] = tid
        return tid

    def _ensure_trajectory(self, tid: int) -> None:
        while tid >= len(self._trajectory_states):
            self.add_trajectory()

    def finish_trajectory(self, trajectory_id: int) -> None:
        self._ensure_trajectory(trajectory_id)
        self._trajectory_states[trajectory_id] = "FINISHED"

    def freeze_trajectory(self, trajectory_id: int) -> None:
        self._ensure_trajectory(trajectory_id)
        self._trajectory_states[trajectory_id] = "FROZEN"
        for s in self.submaps:
            if s.trajectory_id == trajectory_id:
                s.frozen = True
        for n in self.nodes:
            if n.trajectory_id == trajectory_id:
                n.frozen = True

    def trajectory_states(self) -> Dict[int, str]:
        return dict(self._trajectory_states)

    def _find(self, tid: int) -> int:
        root = tid
        while self._conn_parent[root] != root:
            root = self._conn_parent[root]
        while self._conn_parent[tid] != root:
            self._conn_parent[tid], tid = root, self._conn_parent[tid]
        return root

    def connect_trajectories(self, a: int, b: int, time: float) -> None:
        self._ensure_trajectory(max(a, b))
        self._conn_parent[self._find(a)] = self._find(b)
        key = (min(a, b), max(a, b))
        self._last_connection[key] = max(self._last_connection.get(key, float("-inf")), time)

    def trajectories_connected(self, a: int, b: int) -> bool:
        if a == b:
            return True
        if a >= len(self._trajectory_states) or b >= len(self._trajectory_states):
            return False
        return self._find(a) == self._find(b)

    def last_connection_time(self, a: int, b: int) -> float:
        if a == b:
            return float("inf")
        return self._last_connection.get((min(a, b), max(a, b)), float("-inf"))

    def add_submap(self, local_pose: Rigid3, trajectory_id: int = 0) -> int:
        self._ensure_trajectory(trajectory_id)
        idx = self._traj_submap_counts[trajectory_id]
        self._traj_submap_counts[trajectory_id] = idx + 1
        pose = np_rigid(local_pose)
        self.submaps.append(SubmapRecord(
            local_pose=pose, global_pose=pose,
            histogram=np.zeros(self._num_histogram, np.float32),
            trajectory_id=trajectory_id, index_in_trajectory=idx))
        return len(self.submaps) - 1

    def finish_submap(self, submap_id: int, high_values, low_values) -> None:
        """Keep the finished submap's grids compressed on the device. Each
        grid is a dense flat grid (compressed here) or an already-captured
        CompressedGrid (the brick path compresses on capture)."""
        s = self.submaps[submap_id]

        def keep(values, spec, capacity):
            if isinstance(values, CompressedGrid):
                return CompressedGrid(*(torch.as_tensor(x).to(self.device) for x in values))
            return compress(torch.as_tensor(values).to(self.device), spec, capacity)

        s.high = keep(high_values, self._hi_spec, self._compress_capacity)
        s.low = keep(low_values, self._lo_spec, self.low_compress_capacity)
        # the top-down image is projected lazily on a search worker
        s.finished = True

    def add_node(self, node: NodeRecord, insertion_submap_ids: Tuple[int, ...],
                 newly_finished_submap_id: int = -1, finished_grids=None) -> int:
        """AddNode + ComputeConstraintsForNode (pose_graph_3d.cc:335-399)."""
        self._ensure_trajectory(node.trajectory_id)
        node.submap_ids = tuple(insertion_submap_ids)
        node_local = np_rigid(node.local_pose)
        with self._mutex:  # the pool-task SPA rewrites global poses
            node_id = len(self.nodes)
            first = self.submaps[insertion_submap_ids[0]]
            node.global_pose = np_compose(first.global_pose,
                                          np_compose(np_inverse(first.local_pose), node_local))
            self.nodes.append(node)

        node_hist = np.asarray(node.histogram)
        grav_conj = np_quat_conjugate(np.asarray(node.gravity_alignment, np.float64))
        for sid in insertion_submap_ids:
            sub = self.submaps[sid]
            rel = np_compose(np_inverse(sub.local_pose), node_local)
            self._append_constraint(Constraint(
                submap_id=sid, node_id=node_id, relative=rel,
                translation_weight=self.cfg.matcher_translation_weight,
                rotation_weight=self.cfg.matcher_rotation_weight, tag="INTRA"))
            sub.node_ids.append(node_id)
            yaw = np_quat_yaw(np_quat_multiply(rel.rotation, grav_conj))
            sub.histogram += np_rotate_histogram(node_hist, yaw)

        if newly_finished_submap_id >= 0 and finished_grids is not None:
            self.finish_submap(newly_finished_submap_id, *finished_grids)
            sid = newly_finished_submap_id
            if self._pool is not None:
                self._add_task(lambda: self._compute_constraints_for_submap(sid))
                if self._metrics:
                    self._metrics["queue_length"].add().increment()
            else:
                self._compute_constraints_for_submap(sid)

        self._nodes_since_optimization += 1
        if 0 < self.cfg.optimize_every_n_nodes <= self._nodes_since_optimization:
            self._nodes_since_optimization = 0
            if self._pool is not None:
                # one pending pool-task solve at a time; a trigger while one
                # is queued folds into it
                with self._opt_lock:
                    schedule = not self._opt_pending
                    self._opt_pending = True
                if schedule:
                    self._add_task(self._run_optimization_task)
            else:
                self.run_optimization(wait=False)
        return node_id

    def _run_optimization_task(self) -> None:
        try:
            self.run_optimization(wait=False)
        finally:
            with self._opt_lock:
                self._opt_pending = False

    def add_fixed_frame_pose(self, node_id: int, position, weight: Optional[float] = None) -> None:
        w = weight or self.cfg.optimization_problem.fixed_frame_pose_translation_weight
        self.fixed_frame_observations.append((node_id, np.asarray(position, np.float32), float(w)))

    def add_landmark_observation(self, node_id: int, landmark_id: str, position_in_tracking,
                                 weight: float = 1e2, *, rotation_in_tracking=None,
                                 rotation_weight: float = 0.0, node_id2: Optional[int] = None,
                                 alpha: float = 0.0) -> None:
        if landmark_id not in self._landmark_ids:
            self._landmark_ids[landmark_id] = len(self._landmark_ids)
        lid = self._landmark_ids[landmark_id]
        rq = (np.asarray([1.0, 0.0, 0.0, 0.0], np.float32) if rotation_in_tracking is None
              else np.asarray(rotation_in_tracking, np.float32))
        self.landmark_observations.append((
            node_id, node_id if node_id2 is None else node_id2, float(alpha), lid, rq,
            np.asarray(position_in_tracking, np.float32), float(weight), float(rotation_weight)))

    def add_odometry_between(self, node_id: int, node_time: float, odometry, trajectory_id: int = 0,
                             prev_node_id: Optional[int] = None) -> None:
        """Odometry-implied relative pose between this node and its
        same-trajectory predecessor (CalculateOdometryBetweenNodes)."""
        prev = prev_node_id
        if prev is None:
            for nid in range(node_id - 1, -1, -1):
                if self.nodes[nid].trajectory_id == trajectory_id:
                    prev = nid
                    break
        if prev is None:
            return
        t0, t1 = self.nodes[prev].time, node_time
        if not (odometry.has(t0) and odometry.has(t1)):
            return
        p0, p1 = odometry.lookup(t0), odometry.lookup(t1)
        self.odometry_links.append((prev, node_id, np_compose(np_inverse(np_rigid(p0)), np_rigid(p1))))

    def landmark_poses(self) -> Dict[str, np.ndarray]:
        out = {}
        if self._last_landmark_positions is not None:
            for name, lid in self._landmark_ids.items():
                out[name] = self._last_landmark_positions[lid]
        return out

    # ----- loop closure -----

    def _close_submaps(self, submap_id: int) -> List[int]:
        """Older finished submaps within range; the radius scales with the
        candidate budget as the JAX package documents (PARITY.md C20)."""
        me = self.submaps[submap_id]
        out = []
        for sid, s in enumerate(self.submaps):
            if sid == submap_id or not s.finished or s.high is None or s.trimmed:
                continue
            if s.trajectory_id == me.trajectory_id \
                    and abs(s.index_in_trajectory - me.index_in_trajectory) <= 1:
                continue
            d = float(np.linalg.norm(np.asarray(s.global_pose.translation)
                                     - np.asarray(me.global_pose.translation)))
            if d <= self.cfg.max_radius_enable_loop_detection * max(
                    1.0, self.cfg.num_close_submaps_loop_with_initial_value / 5.0):
                out.append((d, sid))
        out.sort()
        return [sid for _, sid in out[: self.cfg.num_close_submaps_loop_with_initial_value]]

    # ----- compiled programs -----

    def _programs(self, device: Optional[torch.device] = None) -> _Programs:
        """The calling thread's search programs on `device` (the pose
        graph's by default), keyed by thread id (a native worker's
        threading.local is new for every task) and device."""
        key = (threading.get_ident(), indexed(self.device if device is None else device))
        with self._programs_lock:
            prog = self._programs_by_thread.get(key)
            if prog is None:
                prog = self._programs_by_thread[key] = _Programs(key[1])
        return prog

    def _decompress(self, sub: SubmapRecord):
        """(g_hi, g_lo, pyramid) of a finished submap: new tensors (the
        graph's result copied off its buffers)."""
        fc_cfg = self.cfg.constraint_builder.fast_correlative_scan_matcher
        inp = (sub.high.indices, sub.high.values, sub.low.indices, sub.low.values)
        g = self._programs().graph(
            ("decompress",) + tuple(x.shape for x in inp), "decompress",
            lambda: decompress_body(self._hi_spec, self._lo_spec, fc_cfg.branch_and_bound_depth,
                                    fc_cfg.full_resolution_depth))
        g_hi, g_lo, levels = g((), inp)[1]
        return g_hi.clone(), g_lo.clone(), Pyramid(levels=tuple(x.clone() for x in levels))

    def _search(self, kind: str, hit, arrays) -> torch.Tensor:
        """One chunk's search (`search_body`) against the cached grids `hit`
        of its target submap, from the chunk's host arrays (the last one,
        the submap histogram, is the chunk's; the others carry the node
        axis); the packed (B, 9) result, a new tensor on `device`. The
        nodes are split over the mesh's shards (without a mesh, one shard
        on `device`), each shard's program queued in turn, then the pieces
        gathered."""
        mesh = self.mesh or Mesh((self.device,))
        nodes, chunk_wide = arrays[:-1], arrays[-1]
        outs, at = [], 0
        for dev, size in zip(mesh.devices, split_sizes(len(nodes[0]), mesh)):
            if size:
                piece = [a[at:at + size] for a in nodes] + [chunk_wide]
                outs.append(self._search_on(self._programs(dev), kind, hit, piece))
                at += size
        outs = [o.to(self.device) for o in outs]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _search_on(self, prog: _Programs, kind: str, hit, arrays) -> torch.Tensor:
        """The search program of `prog` (one thread's programs on one
        device) for the arrays' shapes, its static grids loaded with `hit`;
        the packed result, a new tensor on that device."""
        g = prog.graph((kind,) + tuple(a.shape for a in arrays), kind,
                       lambda: search_body(kind, self.cfg.constraint_builder, self._hi_spec, self._lo_spec),
                       adopt=_grid_leaves)
        prog.load_grids(hit)
        if g.state is None:
            g.bind(prog.grids, [self._stage_array(a, prog.device) for a in arrays])
        g.stage_input(arrays)  # one host-to-device copy
        g.step()
        return g.result.clone()

    def _project(self, hit) -> torch.Tensor:
        """The top-down image of the high grid of `hit`."""
        size = self.cfg.constraint_builder.image_proposal_size
        prog = self._programs()
        g = prog.graph(("project", size), "project", lambda: project_body(self._hi_spec, size),
                       adopt=_grid_leaves)
        prog.load_grids(hit)
        if g.state is None:
            g.bind(prog.grids, ())
        g.step()
        return g.result

    def _propose(self, anchors: np.ndarray, other: np.ndarray, meters: float) -> np.ndarray:
        """(n, 4) host proposals (yaw, shift x, shift y, score) aligning the
        image `other` onto each of `anchors` (n, S, S): one replay, one
        read back."""
        num_yaw = self.cfg.constraint_builder.image_proposal_num_yaw
        arrays = (np.asarray(anchors, np.float32), np.asarray(other, np.float32))
        g = self._programs().graph(("propose", meters, num_yaw) + tuple(a.shape for a in arrays), "propose",
                                   lambda: propose_body(meters, num_yaw))
        if g.state is None:
            if self._on_cuda():
                keep_fft_plans(self.device)  # a live graph reads its cuFFT plans
            g.bind((), [self._stage_array(a) for a in arrays])
        g.stage_input(arrays)
        g.step()
        return self._host(g.result)

    def _stage_array(self, a, device: Optional[torch.device] = None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device if device is None else device)

    def programs(self) -> Dict[str, List[Tuple[tuple, StepGraph]]]:
        """Every compiled program this pose graph made, by name: (key,
        graph), the key naming its shapes."""
        out: Dict[str, list] = collections.defaultdict(list)
        with self._programs_lock:
            for prog in self._programs_by_thread.values():
                for key, g in prog.graphs.items():
                    out[g.name].append((key, g))
            for key, programs in self._spa_graphs.items():
                for g in programs.graphs():
                    out[g.name].append((key, g))
        return dict(out)

    def graph_counts(self) -> Dict[str, Dict[str, int]]:
        """The compiled programs' steps, warm-ups, captures and replays by
        program (decompress, the two searches, project, propose, and the
        SPA's spa_rows, spa_jtj, spa_start, spa_cg and spa, whose steps
        count GN steps), summed over the threads and shards that ran them."""
        return {name: sum_counts(g for _, g in gs) for name, gs in sorted(self.programs().items())}

    def _global_candidates(self, from_id: int) -> List[int]:
        """Finished submaps of other trajectories not (or long not)
        connected to this one: the whole-submap global search."""
        from_sub = self.submaps[from_id]
        from_t = from_sub.trajectory_id
        now = self.nodes[from_sub.node_ids[-1]].time if from_sub.node_ids else float("inf")
        out = []
        for sid, s in enumerate(self.submaps):
            if sid == from_id or not s.finished or s.high is None or s.trimmed:
                continue
            if s.trajectory_id == from_t:
                continue
            stale = now - self.last_connection_time(from_t, s.trajectory_id) \
                > self.cfg.global_constraint_search_after_n_seconds
            if not self.trajectories_connected(from_t, s.trajectory_id) or stale:
                out.append(sid)
        k = self.cfg.num_close_submaps_loop_with_initial_value
        return out[-k:] if k > 0 else []

    def _compute_constraints_for_submap(self, from_id: int) -> int:
        """Timed entry: per-finished-submap search wall latency."""
        t0 = _time.perf_counter()
        try:
            return self._compute_constraints_for_submap_impl(from_id)
        finally:
            self.constraint_search_seconds.append(_time.perf_counter() - t0)

    @staticmethod
    def _stack(arrays, dtype=None) -> np.ndarray:
        """One chunk's per-node arrays as one (B, ...) host array. Unlike
        the JAX package, chunks are not padded to a power of two: each
        padded lane would run a whole branch-and-bound, and the chunk sizes
        (so the graphs per kind) are bounded by
        `max_nodes_per_search_dispatch`."""
        return np.stack([np.asarray(x, dtype) for x in arrays])

    def _compute_constraints_for_submap_impl(self, from_id: int) -> int:
        """ComputeConstraintsBetweenSubmaps (constraint_builder_3d.cc:162):
        every `every_nodes_to_find_constraint`-th node of the finishing
        submap against each close or image-proposed older submap, and
        against submaps of unconnected trajectories with the global search.
        Every chunk's program is queued first; then each chunk is read back
        with one device-to-host copy."""
        added = 0
        cb = self.cfg.constraint_builder
        every = max(1, cb.every_nodes_to_find_constraint)
        from_sub = self.submaps[from_id]
        sampled = from_sub.node_ids[::every]
        image_proposals = self._image_proposals(from_id)
        candidates = list(self._close_submaps(from_id))
        for to_id in image_proposals:
            if to_id not in candidates:
                candidates.append(to_id)
        global_candidates = self._global_candidates(from_id)
        candidates = [c for c in candidates if c not in global_candidates]
        chunk = max(1, cb.max_nodes_per_search_dispatch)

        t_st = _time.perf_counter()
        pending: List[Tuple] = []
        for to_id in candidates:
            to_sub = self.submaps[to_id]
            to_t = np.asarray(to_sub.global_pose.translation)
            node_ids = [
                n for n in sampled
                if not self._has_constraint(to_id, n) and (
                    to_id in image_proposals
                    or float(np.linalg.norm(np.asarray(self.nodes[n].global_pose.translation) - to_t))
                    <= cb.max_constraint_distance)
            ]
            if not node_ids:
                continue
            hit = self._decompressed_grids(to_id)
            submap_hist = np.asarray(to_sub.histogram, np.float32)
            initials = []
            for node_id in node_ids:
                node = self.nodes[node_id]
                if to_id in image_proposals:
                    node_in_from = np_compose(np_inverse(from_sub.local_pose), np_rigid(node.local_pose))
                    initials.append(proposal_to_initial_guess(image_proposals[to_id], node_in_from))
                else:
                    initials.append(self._initial_guess(to_sub, node))
            if self._metrics:
                for _ in node_ids:
                    self._metrics["constraints_searched"].add().increment()
            for lo_i in range(0, len(node_ids), chunk):
                ids_c = node_ids[lo_i:lo_i + chunk]
                initials_c = initials[lo_i:lo_i + chunk]
                nodes = [self.nodes[n] for n in ids_c]
                t_dp = _time.perf_counter()
                out = self._search("search_initial", hit, (
                    self._stack([n.high_points for n in nodes], np.float32),
                    self._stack([n.high_mask for n in nodes], bool),
                    self._stack([n.low_points for n in nodes], np.float32),
                    self._stack([n.low_mask for n in nodes], bool),
                    self._stack([i.rotation for i in initials_c], np.float32),
                    self._stack([i.translation for i in initials_c], np.float32),
                    self._stack([n.histogram for n in nodes], np.float32),
                    self._stack([np_quat_yaw(np.asarray(i.rotation, np.float64)) for i in initials_c],
                                np.float32),
                    submap_hist))
                self._phase("search_dispatch", _time.perf_counter() - t_dp)
                pending.append(("loop", to_id, ids_c, initials_c, out))

        g_stride = max(1, int(round(1.0 / max(self.cfg.global_sampling_ratio, 1e-6))))
        for to_id in global_candidates:
            to_sub = self.submaps[to_id]
            node_ids = [n for n in sampled[::g_stride] if not self._has_constraint(to_id, n)]
            if not node_ids:
                continue
            hit = self._decompressed_grids(to_id)
            submap_hist = np.asarray(to_sub.histogram, np.float32)
            if self._metrics:
                for _ in node_ids:
                    self._metrics["constraints_searched"].add().increment()
            for lo_i in range(0, len(node_ids), chunk):
                ids_c = node_ids[lo_i:lo_i + chunk]
                nodes = [self.nodes[n] for n in ids_c]
                # roll/pitch-consistent rotation guess; yaw is irrelevant
                # under the +-pi search
                to_q = np_quat_conjugate(np.asarray(to_sub.global_pose.rotation, np.float64))
                rots = self._stack([np_quat_multiply(to_q, np.asarray(n.global_pose.rotation, np.float64))
                                    for n in nodes], np.float32)
                t_dp = _time.perf_counter()
                out = self._search("search_full", hit, (
                    self._stack([n.high_points for n in nodes], np.float32),
                    self._stack([n.high_mask for n in nodes], bool),
                    self._stack([n.low_points for n in nodes], np.float32),
                    self._stack([n.low_mask for n in nodes], bool),
                    rots, self._stack([n.histogram for n in nodes], np.float32), submap_hist))
                self._phase("search_dispatch", _time.perf_counter() - t_dp)
                pending.append(("GLOBAL", to_id, ids_c, None, out))
        self._phase("search_stage", _time.perf_counter() - t_st)

        t_dr = _time.perf_counter()
        fetched = [self._host(p[4]) for p in pending]  # one read per chunk
        self._phase("search_drain", _time.perf_counter() - t_dr)
        t_ap = _time.perf_counter()
        for (kind, to_id, ids_c, initials_c, _), out in zip(pending, fetched):
            for i in np.flatnonzero(out[:, 0] > 0.5):
                rot, trans = out[i, 2:6], out[i, 6:9]
                dyaw = 0.0
                if initials_c is not None:
                    dyaw = float(np_quat_yaw(np_quat_multiply(
                        np.asarray(rot, np.float64),
                        np_quat_conjugate(np.asarray(initials_c[i].rotation, np.float64)))))
                with self._mutex:
                    self._append_constraint_locked(Constraint(
                        submap_id=to_id, node_id=ids_c[i], relative=Rigid3(rot.copy(), trans.copy()),
                        translation_weight=cb.loop_closure_translation_weight,
                        rotation_weight=cb.loop_closure_rotation_weight, tag="INTER",
                        score=float(out[i, 1]), yaw_correction=dyaw))
                if cb.log_matches:
                    _LOG.info("%s constraint: node %d -> submap %d score %.3f",
                              kind, ids_c[i], to_id, float(out[i, 1]))
                if self._metrics:
                    self._metrics["constraints_found"].add().increment()
                    self._metrics["constraint_scores"].add().observe(float(out[i, 1]))
                added += 1
        self._phase("search_append", _time.perf_counter() - t_ap)
        if self._metrics and self._pool is not None:
            self._metrics["queue_length"].add().decrement()
        return added

    def _initial_guess(self, to_sub: SubmapRecord, node: NodeRecord) -> Rigid3:
        return np_compose(np_inverse(np_rigid(to_sub.global_pose)), np_rigid(node.global_pose))

    def _submap_image(self, sid: int) -> Optional[SubmapImage]:
        """Cached top-down projection of a finished submap (host numpy),
        made on the calling search worker from the decompressed grid."""
        s = self.submaps[sid]
        if s.image is not None or not s.finished or s.high is None:
            return s.image
        t0 = _time.perf_counter()
        img = self._project(self._decompressed_grids(sid))
        size = self.cfg.constraint_builder.image_proposal_size
        s.image = SubmapImage(self._host(img), meters_per_pixel(self._hi_spec, size))
        self._phase("search_project", _time.perf_counter() - t0)
        return s.image

    def _image_proposals(self, from_id: int):
        """FFT-correlation proposals vs older finished submaps (the
        SURF/FLANN/RANSAC substitute); {to_id: Proposal (host values)} for
        proposals above the score gate. All candidates' correlations are
        queued, then read back with one copy."""
        cb = self.cfg.constraint_builder
        if not cb.use_image_proposals:
            return {}
        from_sub = self.submaps[from_id]
        t0 = _time.perf_counter()
        from_image = self._submap_image(from_id)
        if from_image is None:
            return {}
        candidates = [
            sid for sid, s in enumerate(self.submaps)
            if s.finished and s.high is not None and not s.trimmed and sid < from_id
            and not (s.trajectory_id == from_sub.trajectory_id
                     and abs(s.index_in_trajectory - from_sub.index_in_trajectory) <= 1)
        ]
        candidates = candidates[-cb.max_image_proposal_candidates:]
        candidates = [sid for sid in candidates if self._submap_image(sid) is not None]
        if not candidates:
            return {}

        meters = {float(self.submaps[sid].image.meters_per_pixel) for sid in candidates}
        if len(meters) != 1:
            raise ValueError(f"submap images of different scales {sorted(meters)}")
        host = self._propose(np.stack([np.asarray(self.submaps[sid].image.image) for sid in candidates]),
                             from_image.image, meters.pop())
        out = {}
        for to_id, (yaw, sx, sy, score) in zip(candidates, host):
            if float(score) >= cb.image_proposal_min_score:
                out[to_id] = _HostProposal(yaw=yaw, shift_xy=np.asarray([sx, sy]), score=score)
        self._phase("search_propose", _time.perf_counter() - t0)
        return out

    def _append_constraint(self, c: Constraint) -> None:
        with self._mutex:
            self._append_constraint_locked(c)

    def _append_constraint_locked(self, c: Constraint) -> None:
        self.constraints.append(c)
        self._constraint_index.add((c.submap_id, c.node_id))
        if c.tag == "INTER":
            t_sub = self.submaps[c.submap_id].trajectory_id
            node = self.nodes[c.node_id]
            if t_sub != node.trajectory_id:
                self.connect_trajectories(t_sub, node.trajectory_id, node.time)

    def reindex_constraints(self) -> None:
        with self._mutex:
            self._constraint_index = {(c.submap_id, c.node_id) for c in self.constraints}

    def _has_constraint(self, submap_id: int, node_id: int) -> bool:
        with self._mutex:
            return (submap_id, node_id) in self._constraint_index

    # ----- optimization (RunOptimization, pose_graph_3d.cc:444-515, 722) -----

    def _build_problem(self) -> Tuple[Dict[str, np.ndarray], int, int, Tuple[bool, bool, bool]]:
        """The SPA problem from a consistent snapshot (counts taken under
        the mutex; append-only lists read up to them). Returns (host arrays
        by `PoseGraphData` field, in field order; n_submaps; n_nodes; which
        of the node-node, fixed-frame and landmark blocks have rows)."""
        with self._mutex:
            submaps = self.submaps[: len(self.submaps)]
            nodes = self.nodes[: len(self.nodes)]
            constraints = self.constraints[: len(self.constraints)]
            ff_obs = list(self.fixed_frame_observations)
            lm_obs = list(self.landmark_observations)
            odom_links = list(self.odometry_links)
            submap_poses = [(s.global_pose.rotation, s.global_pose.translation) for s in submaps]
            node_poses = [(n.global_pose.rotation, n.global_pose.translation) for n in nodes]
        constraints = [c for c in constraints if c.node_id < len(nodes) and c.submap_id < len(submaps)]
        S, N, C = self.cfg.max_submaps, self.cfg.max_nodes, self.cfg.max_constraints
        if len(submaps) > S or len(nodes) > N or len(constraints) > C:
            raise RuntimeError("pose graph capacity exceeded; raise max_* config")
        data = opt.make_pose_graph_data(S, N, C)  # host template, shapes only
        sq = np.zeros((S, 4), np.float32); sq[:, 0] = 1
        st = np.zeros((S, 3), np.float32)
        sv = np.zeros(S, bool)
        for i, (q, t) in enumerate(submap_poses):
            sq[i], st[i], sv[i] = q, t, True
        nq = np.zeros((N, 4), np.float32); nq[:, 0] = 1
        nt = np.zeros((N, 3), np.float32)
        nv = np.zeros(N, bool)
        for i, (q, t) in enumerate(node_poses):
            nq[i], nt[i], nv[i] = q, t, True
        sfx = np.array([s.frozen for s in submaps] + [False] * (S - len(submaps)), bool)
        # gauge fixing per connected component (see the JAX package's
        # _build_problem for the anchoring rules)
        parent = list(range(len(submaps)))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        first_sub_of_node: Dict[int, int] = {}
        for c in constraints:
            if c.node_id in first_sub_of_node:
                parent[find(first_sub_of_node[c.node_id])] = find(c.submap_id)
            else:
                first_sub_of_node[c.node_id] = c.submap_id
        anchored = set()
        for i, sub in enumerate(submaps):
            if sub.frozen:
                anchored.add(find(i))
        gps_comps = set()
        for nid, _, _ in ff_obs:
            if nid in first_sub_of_node:
                r = find(first_sub_of_node[nid])
                if r in anchored or r in gps_comps:
                    continue
                if not gps_comps:
                    for i in range(len(submaps)):
                        if find(i) == r:
                            sfx[i] = True
                            anchored.add(r)
                            break
                gps_comps.add(r)
        anchored |= gps_comps
        for i in range(len(submaps)):
            r = find(i)
            if r not in anchored:
                sfx[i] = True
                anchored.add(r)
        nfx = np.array([n.frozen for n in nodes] + [False] * (N - len(nodes)), bool)
        cs = np.zeros(C, np.int32); cn = np.zeros(C, np.int32)
        cq = np.zeros((C, 4), np.float32); cq[:, 0] = 1
        ct = np.zeros((C, 3), np.float32)
        ctw = np.zeros(C, np.float32); crw = np.zeros(C, np.float32)
        cv = np.zeros(C, bool); ci = np.zeros(C, bool)
        for i, c in enumerate(constraints):
            cs[i], cn[i] = c.submap_id, c.node_id
            cq[i], ct[i] = np.asarray(c.relative.rotation), np.asarray(c.relative.translation)
            ctw[i], crw[i] = c.translation_weight, c.rotation_weight
            cv[i], ci[i] = True, c.tag == "INTER"
        F = data.ff_node.shape[0]
        ffn = np.zeros(F, np.int32); fft = np.zeros((F, 3), np.float32)
        ffw = np.zeros(F, np.float32); ffv = np.zeros(F, bool)
        for i, (nid, pos, w) in enumerate(ff_obs[-F:]):
            ffn[i], fft[i], ffw[i], ffv[i] = nid, pos, w, True
        L = data.lm_node.shape[0]
        lmn = np.zeros(L, np.int32); lmn2 = np.zeros(L, np.int32)
        lma = np.zeros(L, np.float32); lmi = np.zeros(L, np.int32)
        lmq = np.zeros((L, 4), np.float32); lmq[:, 0] = 1
        lmr = np.zeros((L, 3), np.float32)
        lmtw = np.zeros(L, np.float32); lmrw = np.zeros(L, np.float32)
        lmv = np.zeros(L, bool)
        K = data.lm_positions.shape[0]
        lmp = np.zeros((K, 3), np.float32)
        lmpq = np.zeros((K, 4), np.float32); lmpq[:, 0] = 1
        lmpv = np.zeros(K, bool)
        for i, (nid, nid2, alpha, lid, rq, rel, tw, rw) in enumerate(lm_obs[-L:]):
            lmn[i], lmn2[i], lma[i] = nid, nid2, alpha
            lmi[i], lmq[i], lmr[i] = min(lid, K - 1), rq, rel
            lmtw[i], lmrw[i] = tw, rw
            lmv[i] = lid < K
            if lid < K and not lmpv[lid]:
                q, t = node_poses[nid]
                lmp[lid] = np_quat_rotate(np.asarray(q, np.float64), np.asarray(rel, np.float64)) + t
                lmpq[lid] = np_quat_multiply(np.asarray(q, np.float64), np.asarray(rq, np.float64))
                lmpv[lid] = True
        Q = data.nn_first.shape[0]
        nnf = np.zeros(Q, np.int32); nns = np.zeros(Q, np.int32)
        nnq = np.zeros((Q, 4), np.float32); nnq[:, 0] = 1
        nnt = np.zeros((Q, 3), np.float32)
        nntw = np.zeros(Q, np.float32); nnrw = np.zeros(Q, np.float32)
        nnv = np.zeros(Q, bool)
        op = self.cfg.optimization_problem
        if op.use_consecutive_node_costs:
            links = [(a, b, rel, op.odometry_translation_weight, op.odometry_rotation_weight)
                     for a, b, rel in odom_links]
            prev_by_traj: Dict[int, int] = {}
            for nid, node in enumerate(nodes):
                p = prev_by_traj.get(node.trajectory_id)
                if p is not None and not node.frozen:
                    rel = np_compose(np_inverse(np_rigid(nodes[p].local_pose)), np_rigid(node.local_pose))
                    links.append((p, nid, rel, op.local_slam_pose_translation_weight,
                                  op.local_slam_pose_rotation_weight))
                prev_by_traj[node.trajectory_id] = nid
            for i, (a, b, rel, tw, rw) in enumerate(links[-Q:]):
                nnf[i], nns[i] = a, b
                nnq[i], nnt[i] = np.asarray(rel.rotation), np.asarray(rel.translation)
                nntw[i], nnrw[i], nnv[i] = tw, rw, True
        host = dict(
            submap_q=sq, submap_t=st, submap_valid=sv, node_q=nq, node_t=nt, node_valid=nv,
            c_submap=cs, c_node=cn, c_q=cq, c_t=ct, c_trans_weight=ctw, c_rot_weight=crw,
            c_valid=cv, c_is_inter=ci, submap_fixed=sfx, node_fixed=nfx,
            ff_node=ffn, ff_t=fft, ff_weight=ffw, ff_valid=ffv,
            lm_node=lmn, lm_node2=lmn2, lm_alpha=lma, lm_id=lmi, lm_rel_q=lmq, lm_rel_t=lmr,
            lm_trans_weight=lmtw, lm_rot_weight=lmrw, lm_valid=lmv,
            lm_q=lmpq, lm_positions=lmp, lm_pos_valid=lmpv,
            nn_first=nnf, nn_second=nns, nn_q=nnq, nn_t=nnt, nn_trans_weight=nntw,
            nn_rot_weight=nnrw, nn_valid=nnv,
        )
        host = {k: host[k] for k in opt.PoseGraphData._fields}
        return host, len(submaps), len(nodes), (bool(nnv.any()), bool(ffv.any()), bool(lmv.any()))

    def _solve(self, problem: Dict[str, np.ndarray], iterations: int, blocks) -> np.ndarray:
        """The SPA solve of the host problem: its submap, node and landmark
        poses, flat on the host (one read). The programs of this problem's
        shapes and blocks over the mesh (without one, a single shard on
        `device`), `iterations` GN steps under their lock."""
        mesh = self.mesh or Mesh((self.device,))
        key = ("spa", blocks, mesh) + tuple(v.shape for v in problem.values())
        with self._programs_lock:
            if key not in self._spa_graphs:
                self._spa_graphs[key] = _SpaPrograms(self.cfg.optimization_problem, blocks, mesh)
            programs = self._spa_graphs[key]
        with programs.lock:
            return self._read_poses(programs.solve(problem, iterations))

    def _read_poses(self, d: opt.PoseGraphData) -> np.ndarray:
        return self._host(torch.cat([d.submap_q.reshape(-1), d.submap_t.reshape(-1), d.node_q.reshape(-1),
                                     d.node_t.reshape(-1), d.lm_positions.reshape(-1)]))

    def wait_for_all_computations(self) -> None:
        """WaitForAllComputations (pose_graph_3d.cc:517-533)."""
        if self._pool is not None:
            self._pool.wait_all()

    def run_optimization(self, iterations: Optional[int] = None, wait: bool = True) -> None:
        """Solve the SPA problem (see the JAX package for the semantics of
        `iterations` and `wait`). Only the snapshot's members take solver
        output; submaps and nodes added during the solve are extrapolated
        through their trajectory's correction, all under `_mutex`."""
        if wait:
            self.wait_for_all_computations()
        if not self.constraints or len(self.submaps) < 2:
            self._nodes_since_optimization = 0
            return
        iters = self.cfg.optimization_problem.max_num_iterations if iterations is None else iterations
        if iters <= 0:
            self._nodes_since_optimization = 0
            return
        t0 = _time.perf_counter()
        op = self.cfg.optimization_problem
        problem, n_sub, n_node, blocks = self._build_problem()
        s_cap, n_cap = problem["submap_q"].shape[0], problem["node_q"].shape[0]
        host = self._solve(problem, iters, blocks)
        o = 0
        parts = []
        for n in (s_cap * 4, s_cap * 3, n_cap * 4, n_cap * 3):
            parts.append(host[o:o + n])
            o += n
        sq, st = parts[0].reshape(-1, 4), parts[1].reshape(-1, 3)
        nq, nt = parts[2].reshape(-1, 4), parts[3].reshape(-1, 3)
        self._last_landmark_positions = host[o:].reshape(-1, 3)
        with self._mutex:
            last_by_traj = {s.trajectory_id: i for i, s in enumerate(self.submaps[:n_sub])}
            old_last = {t: self.submaps[i].global_pose for t, i in last_by_traj.items()}
            for i, s in enumerate(self.submaps[:n_sub]):
                s.global_pose = np_rigid(Rigid3(sq[i], st[i]))
            for i, node in enumerate(self.nodes[:n_node]):
                node.global_pose = np_rigid(Rigid3(nq[i], nt[i]))
            corrections = {t: np_compose(self.submaps[i].global_pose, np_inverse(old_last[t]))
                           for t, i in last_by_traj.items()}
            for s in self.submaps[n_sub:]:
                c = corrections.get(s.trajectory_id)
                if c is not None:
                    s.global_pose = np_compose(c, s.global_pose)
            for node in self.nodes[n_node:]:
                c = corrections.get(node.trajectory_id)
                if c is not None:
                    node.global_pose = np_compose(c, node.global_pose)
        self._nodes_since_optimization = 0
        self._phase("spa", _time.perf_counter() - t0)
        if op.log_solver_summary:
            _LOG.info("SPA solve: %d GN iters, %d submaps, %d nodes, %d constraints in %.3f s",
                      iters, n_sub, n_node, len(self.constraints), _time.perf_counter() - t0)
        if self.cfg.log_residual_histograms:
            self._log_residual_histogram()

    def _log_residual_histogram(self) -> None:
        errs = []
        for c in self.constraints:
            h = np_compose(np_inverse(np_rigid(self.submaps[c.submap_id].global_pose)),
                           np_rigid(self.nodes[c.node_id].global_pose))
            errs.append(float(np.linalg.norm(h.translation - np.asarray(c.relative.translation))))
        if not errs:
            return
        hist, edges = np.histogram(np.asarray(errs), bins=10)
        _LOG.info("constraint translation residuals: %s", ", ".join(
            f"[{edges[i]:.2f},{edges[i + 1]:.2f}):{hist[i]}" for i in range(len(hist))))

    def run_final_optimization(self) -> None:
        """RunFinalOptimization (max_num_final_iterations, :722), capped at
        50 GN steps of 64 CG steps each, as the JAX package does."""
        self.run_optimization(iterations=min(self.cfg.max_num_final_iterations, 50))

    # ----- queries -----

    def node_poses(self) -> List[Rigid3]:
        return [n.global_pose for n in self.nodes]

    def submap_poses(self) -> List[Rigid3]:
        return [s.global_pose for s in self.submaps]

    def constraint_list(self) -> List[Constraint]:
        return list(self.constraints)

    def submap_query(self, submap_id: int) -> dict:
        """Single-submap texture and pose query (MapBuilder::SubmapToProto,
        map_builder.cc:186-204)."""
        if not (0 <= submap_id < len(self.submaps)):
            raise KeyError(f"Requested submap {submap_id} but it does not exist")
        s = self.submaps[submap_id]
        out = {
            "submap_id": submap_id,
            "trajectory_id": s.trajectory_id,
            "submap_index": s.index_in_trajectory,
            "version": len(s.node_ids),
            "finished": bool(s.finished),
            "trimmed": bool(s.trimmed),
            "local_pose_q": np.asarray(s.local_pose.rotation, np.float32),
            "local_pose_t": np.asarray(s.local_pose.translation, np.float32),
            "global_pose_q": np.asarray(s.global_pose.rotation, np.float32),
            "global_pose_t": np.asarray(s.global_pose.translation, np.float32),
        }
        if s.finished and s.high is not None:
            # projected eagerly where no search has: the asking thread keeps
            # no program
            img = s.image
            if img is None:
                cb = self.cfg.constraint_builder
                kw = {"out_size": cb.image_proposal_size} if cb.use_image_proposals else {}
                g = project_to_image(decompress(s.high, self._hi_spec), self._hi_spec, **kw)
                img = SubmapImage(self._host(g.image), g.meters_per_pixel)
            out["texture"] = np.asarray(np.clip(np.asarray(img.image) * 255.0, 0, 255), np.uint8)
            out["meters_per_pixel"] = float(img.meters_per_pixel)
        return out

    def num_inter_constraints(self) -> int:
        return sum(1 for c in self.constraints if c.tag == "INTER")

    def trim_to_last_submaps(self, keep: int) -> int:
        """PureLocalizationTrimmer: drop the heavy data of all but the
        newest `keep` unfrozen submaps."""
        self.wait_for_all_computations()
        unfrozen = [(sid, s) for sid, s in enumerate(self.submaps) if not s.frozen]
        trimmed = 0
        if len(unfrozen) <= keep:
            return 0
        for sid, s in unfrozen[: len(unfrozen) - keep]:
            if not s.trimmed and s.finished:
                s.high = None
                s.low = None
                s.image = None
                s.trimmed = True
                with self._phase_lock:
                    self._grid_cache.pop(sid, None)
                trimmed += 1
        return trimmed


@dataclass
class _HostProposal:
    """An image proposal read back to the host."""

    yaw: float
    shift_xy: np.ndarray
    score: float

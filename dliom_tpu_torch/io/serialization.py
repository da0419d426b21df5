"""Map state serialization (checkpoint / resume); port of
dliom_tpu/io/serialization.py.

Counterpart of the reference's pbstream serialization
(`cartographer/io/internal/mapping_state_serialization.cc:193-208` writes, in
order: pose graph, options, submaps, nodes, trajectory data, sensor data;
`MapBuilder::LoadState`, map_builder.cc:209-367 restores, optionally frozen).

Map state. The container is a compressed .npz with the JAX package's
schema, key for key (`schema`, `meta`, `submap/{i}/...`, `node/{i}/...`,
`constraints/...`), so a state written by either package loads into the
other. Poses are stored as float64 (the port's host poses; the JAX package
writes float32 and reads either). Finished submaps' compressed grids are
tensors on the pose graph's device: saved as numpy, loaded onto `pg.device`.
Node data stays host numpy.

Live checkpoint. `save_live_checkpoint` adds, under `live/` keys and a
`live_meta` JSON blob, everything a running `MapBuilder` needs to continue
exactly where it stopped. The port departs from the JAX package here on
purpose:
  * each trajectory's `LioState` is saved tensor by tensor under its field
    path (`live/t0/state/frontend.submaps.high_values`), and restored
    against a `make_lio_state` template on the builder's device, field by
    field, shape, dtype and device checked (the JAX package stores the
    flattened leaves by position);
  * host state the JAX package drops is serialized and restored: the pose
    graph's fixed-frame, landmark and odometry observations, the per-node
    counter of the periodic optimization, trajectory states and frozen
    flags, the nodes' exact clouds (the map state keeps them quantized to
    1 mm, and later loop searches read them); per trajectory the fixed-frame, landmark and odometry buffers,
    the accumulation buffers, the synchronizer's partial merges, the static
    initializer's samples, the NavSat anchor, the out-of-order counter and
    the local results;
  * what cannot be restored equal is refused with ValueError: a trajectory
    inside the NDT dynamic initializer's window, and a native collator
    holding queued items.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from dliom_tpu_torch.backend.compression import CompressedGrid
from dliom_tpu_torch.backend.pose_graph import Constraint, NodeRecord, PoseGraph, SubmapRecord
from dliom_tpu_torch.common.config import EngineConfig, load_config
from dliom_tpu_torch.sensor import compressed_point_cloud as cpc
from dliom_tpu_torch.transform.rigid import Rigid3, np_rigid

SCHEMA_VERSION = 1
LIVE_FORMAT = "dliom_tpu_torch.live/1"


def _json_blob(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _read_json(z, key: str):
    return json.loads(bytes(z[key]).decode())


def _opt_float(x) -> Optional[float]:
    return None if x is None else float(x)


def _pose_arr(pose: Rigid3) -> np.ndarray:
    return np.concatenate([np.asarray(pose.rotation, np.float64),
                           np.asarray(pose.translation, np.float64)])


def _arr_pose(a: np.ndarray) -> Rigid3:
    return np_rigid(Rigid3(a[:4], a[4:7]))


def _load_cloud(z, prefix):
    """Decompress a stored node cloud back to (capacity, 3) + mask."""
    c = cpc.CompressedPointCloud(
        block_origins=z[f"{prefix}_origins"],
        block_counts=z[f"{prefix}_counts"],
        packed=z[f"{prefix}_packed"],
        num_points=int(z[f"{prefix}_packed"].shape[0]),
    )
    pts = cpc.decompress(c)
    cap = int(z[f"{prefix}_capacity"])
    out = np.zeros((cap, 3), np.float32)
    n = min(len(pts), cap)
    out[:n] = pts[:n]
    return out, np.arange(cap) < n


# ---------------------------------------------------------------------------
# Map state (SerializeState / LoadState)
# ---------------------------------------------------------------------------


def save_state(path: str, pose_graph: PoseGraph, config_preset: str = "basic") -> None:
    """SerializeState (map_builder.cc:205)."""
    np.savez_compressed(path, **_state_arrays(pose_graph, config_preset))


def _state_arrays(pose_graph: PoseGraph, config_preset: str = "basic") -> dict:
    data = {"schema": np.int32(SCHEMA_VERSION)}
    meta = {
        "num_submaps": len(pose_graph.submaps),
        "num_nodes": len(pose_graph.nodes),
        "num_constraints": len(pose_graph.constraints),
        "preset": config_preset,
    }
    data["meta"] = _json_blob(meta)

    for i, s in enumerate(pose_graph.submaps):
        data[f"submap/{i}/local_pose"] = _pose_arr(s.local_pose)
        data[f"submap/{i}/global_pose"] = _pose_arr(s.global_pose)
        data[f"submap/{i}/finished"] = np.asarray(s.finished)
        data[f"submap/{i}/node_ids"] = np.asarray(s.node_ids, np.int32)
        data[f"submap/{i}/trajectory"] = np.asarray([s.trajectory_id, s.index_in_trajectory], np.int32)
        if s.histogram is not None:
            data[f"submap/{i}/histogram"] = np.asarray(s.histogram)
        if s.finished and s.high is not None:
            for tag, grid in (("high", s.high), ("low", s.low)):
                data[f"submap/{i}/{tag}_idx"] = pose_graph._host(grid.indices)
                data[f"submap/{i}/{tag}_val"] = pose_graph._host(grid.values)
                data[f"submap/{i}/{tag}_count"] = pose_graph._host(grid.count)

    for i, n in enumerate(pose_graph.nodes):
        data[f"node/{i}/time"] = np.asarray(n.time)
        data[f"node/{i}/local_pose"] = _pose_arr(n.local_pose)
        data[f"node/{i}/global_pose"] = _pose_arr(n.global_pose)
        data[f"node/{i}/gravity"] = np.asarray(n.gravity_alignment)
        # node clouds stored bit-packed (sensor::CompressedPointCloud,
        # serialization.proto TrajectoryNodeData) at ~1/3 the raw size
        for tag, pts, mask in (("high", n.high_points, n.high_mask), ("low", n.low_points, n.low_mask)):
            c = cpc.compress(np.asarray(pts)[np.asarray(mask)])
            data[f"node/{i}/{tag}_origins"] = c.block_origins
            data[f"node/{i}/{tag}_counts"] = c.block_counts
            data[f"node/{i}/{tag}_packed"] = c.packed
            data[f"node/{i}/{tag}_capacity"] = np.int32(np.asarray(pts).shape[0])
        data[f"node/{i}/histogram"] = np.asarray(n.histogram)
        data[f"node/{i}/submap_ids"] = np.asarray(n.submap_ids, np.int32)
        data[f"node/{i}/trajectory"] = np.int32(n.trajectory_id)

    c = pose_graph.constraints
    data["constraints/submap"] = np.asarray([x.submap_id for x in c], np.int32)
    data["constraints/node"] = np.asarray([x.node_id for x in c], np.int32)
    data["constraints/pose"] = (np.stack([_pose_arr(x.relative) for x in c]) if c
                                else np.zeros((0, 7), np.float32))
    data["constraints/tw"] = np.asarray([x.translation_weight for x in c], np.float32)
    data["constraints/rw"] = np.asarray([x.rotation_weight for x in c], np.float32)
    data["constraints/inter"] = np.asarray([x.tag == "INTER" for x in c], bool)
    return data


def load_state(path: str, config: Optional[EngineConfig] = None, frozen: bool = False,
               device=None) -> PoseGraph:
    """LoadState into a fresh PoseGraph on `device` (the card by default).
    With frozen=True, constraints are restored but the loaded trajectories
    are excluded from re-optimization (pure localization uses this as the
    reference map)."""
    z = np.load(path, allow_pickle=False)
    meta = _read_json(z, "meta")
    config = config or load_config(meta.get("preset", "basic"))
    pg = PoseGraph(config.pose_graph, config.trajectory_builder, device=device)
    load_state_into(pg, path, config, frozen=frozen)
    return pg


def load_state_into(pg: PoseGraph, path: str, config: Optional[EngineConfig] = None,
                    frozen: bool = False, keep_trajectory_ids: bool = False) -> dict:
    """Append a saved state to an EXISTING pose graph, remapping loaded
    trajectory ids onto freshly registered ones and offsetting node/submap
    ids past the graph's current contents (map_builder.cc:220-234's
    trajectory remapping). With `keep_trajectory_ids` (the live checkpoint's
    restore into an empty graph) the saved ids are kept. Returns
    {loaded_tid: new_tid}."""
    z = np.load(path, allow_pickle=False)
    meta = _read_json(z, "meta")
    sub_off = len(pg.submaps)
    node_off = len(pg.nodes)
    tid_map: dict = {}

    def map_tid(loaded: int) -> int:
        if loaded not in tid_map:
            if keep_trajectory_ids:
                pg._ensure_trajectory(loaded)
                tid_map[loaded] = loaded
            else:
                tid_map[loaded] = pg.add_trajectory(frozen=frozen)
        return tid_map[loaded]

    def grid(i, tag) -> CompressedGrid:
        return CompressedGrid(*(torch.from_numpy(np.array(z[f"submap/{i}/{tag}_{k}"])).to(pg.device)
                                for k in ("idx", "val", "count")))

    for i in range(meta["num_submaps"]):
        if f"submap/{i}/trajectory" in z:
            tid_l, idx = (int(v) for v in z[f"submap/{i}/trajectory"])
        else:  # legacy (schema 1 pre-trajectory) states: one trajectory
            tid_l, idx = 0, i
        tid = map_tid(tid_l)
        rec = SubmapRecord(
            local_pose=_arr_pose(z[f"submap/{i}/local_pose"]),
            global_pose=_arr_pose(z[f"submap/{i}/global_pose"]),
            finished=bool(z[f"submap/{i}/finished"]),
            node_ids=[int(n) + node_off for n in z[f"submap/{i}/node_ids"]],
            histogram=z[f"submap/{i}/histogram"] if f"submap/{i}/histogram" in z else None,
            trajectory_id=tid,
            index_in_trajectory=idx,
        )
        pg._traj_submap_counts[tid] = max(pg._traj_submap_counts.get(tid, 0), idx + 1)
        if f"submap/{i}/high_idx" in z:
            rec.high, rec.low = grid(i, "high"), grid(i, "low")
        rec.frozen = frozen
        pg.submaps.append(rec)
    for i in range(meta["num_nodes"]):
        hi_points, hi_mask = _load_cloud(z, f"node/{i}/high")
        lo_points, lo_mask = _load_cloud(z, f"node/{i}/low")
        tid_l = int(z[f"node/{i}/trajectory"]) if f"node/{i}/trajectory" in z else 0
        pg.nodes.append(NodeRecord(
            time=float(z[f"node/{i}/time"]),
            local_pose=_arr_pose(z[f"node/{i}/local_pose"]),
            global_pose=_arr_pose(z[f"node/{i}/global_pose"]),
            gravity_alignment=z[f"node/{i}/gravity"],
            high_points=hi_points,
            high_mask=hi_mask,
            low_points=lo_points,
            low_mask=lo_mask,
            histogram=z[f"node/{i}/histogram"],
            submap_ids=tuple(int(s) + sub_off for s in z[f"node/{i}/submap_ids"]),
            frozen=frozen,
            trajectory_id=map_tid(tid_l),
        ))
    n_c = meta["num_constraints"]
    for i in range(n_c):
        pg.constraints.append(Constraint(
            submap_id=int(z["constraints/submap"][i]) + sub_off,
            node_id=int(z["constraints/node"][i]) + node_off,
            relative=_arr_pose(z["constraints/pose"][i]),
            translation_weight=float(z["constraints/tw"][i]),
            rotation_weight=float(z["constraints/rw"][i]),
            tag="INTER" if bool(z["constraints/inter"][i]) else "INTRA",
        ))
    pg.reindex_constraints()
    # loaded INTER constraints re-establish trajectory connectivity
    for c in pg.constraints[-n_c:] if n_c else []:
        if c.tag == "INTER":
            t_sub = pg.submaps[c.submap_id].trajectory_id
            t_node = pg.nodes[c.node_id].trajectory_id
            if t_sub != t_node:
                pg.connect_trajectories(t_sub, t_node, pg.nodes[c.node_id].time)
    return tid_map


# ---------------------------------------------------------------------------
# Live checkpoint
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def state_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(field path, tensor) of every tensor of a NamedTuple tree, in field
    order; None fields are skipped, any other leaf raises TypeError."""
    for name in tree._fields:
        value = getattr(tree, name)
        path = f"{prefix}{name}"
        if value is None:
            continue
        if _is_namedtuple(value):
            yield from state_leaves(value, path + ".")
        elif isinstance(value, torch.Tensor):
            yield path, value
        else:
            raise TypeError(f"state field {path} is a {type(value).__name__}, not a tensor")


def _rebuild(template, values: Dict[str, torch.Tensor], prefix: str = ""):
    fields = {}
    for name in template._fields:
        value = getattr(template, name)
        path = f"{prefix}{name}"
        if _is_namedtuple(value):
            value = _rebuild(value, values, path + ".")
        elif isinstance(value, torch.Tensor):
            value = values[path]
        fields[name] = value
    return type(template)(**fields)


def _refuse_unrestorable(tid: int, t) -> None:
    init = t._dyn_init
    if init is not None and not t._initialized and (init._last_points is not None or init._seg_dts):
        raise ValueError(
            f"trajectory {tid}: inside the NDT dynamic initializer's window (its buffered scans "
            "and IMU segment cannot be checkpointed); checkpoint after initialization")
    if t._collator is not None and t._collator._payloads:
        raise ValueError(
            f"trajectory {tid}: the native collator holds {len(t._collator._payloads)} queued "
            "items, which cannot be checkpointed; checkpoint when it has dispatched them")


_NODE_CLOUDS = ("high_points", "high_mask", "low_points", "low_mask")


def _pose_graph_extras(pg: PoseGraph, data: dict) -> dict:
    """The live parts of the pose graph the map state leaves out."""
    ff = pg.fixed_frame_observations
    data["live/pg/ff_node"] = np.asarray([o[0] for o in ff], np.int32)
    data["live/pg/ff_pos"] = np.asarray([o[1] for o in ff], np.float32).reshape(-1, 3)
    data["live/pg/ff_weight"] = np.asarray([o[2] for o in ff], np.float64)
    lm = pg.landmark_observations
    data["live/pg/lm_nodes"] = np.asarray([(o[0], o[1]) for o in lm], np.int32).reshape(-1, 2)
    data["live/pg/lm_id"] = np.asarray([o[3] for o in lm], np.int32)
    data["live/pg/lm_scalars"] = np.asarray([(o[2], o[6], o[7]) for o in lm], np.float64).reshape(-1, 3)
    data["live/pg/lm_rot"] = np.asarray([o[4] for o in lm], np.float32).reshape(-1, 4)
    data["live/pg/lm_pos"] = np.asarray([o[5] for o in lm], np.float32).reshape(-1, 3)
    od = pg.odometry_links
    data["live/pg/odom_nodes"] = np.asarray([(a, b) for a, b, _ in od], np.int32).reshape(-1, 2)
    data["live/pg/odom_pose"] = np.asarray([_pose_arr(r) for _, _, r in od], np.float64).reshape(-1, 7)
    data["live/pg/submap_frozen"] = np.asarray([s.frozen for s in pg.submaps], bool)
    data["live/pg/submap_trimmed"] = np.asarray([s.trimmed for s in pg.submaps], bool)
    data["live/pg/node_frozen"] = np.asarray([n.frozen for n in pg.nodes], bool)
    # the map state keeps node clouds 1 mm-quantized and block-sorted; the
    # loop search of later submaps reads them, so the exact clouds are kept
    for i, n in enumerate(pg.nodes):
        for f in _NODE_CLOUDS:
            data[f"live/node/{i}/{f}"] = np.asarray(getattr(n, f))
    data["live/pg/constraint_score"] = np.asarray([c.score for c in pg.constraints], np.float64)
    data["live/pg/constraint_yaw"] = np.asarray([c.yaw_correction for c in pg.constraints], np.float64)
    if pg._last_landmark_positions is not None:
        data["live/pg/landmark_positions"] = np.asarray(pg._last_landmark_positions)
    return {
        "trajectory_states": {str(k): v for k, v in pg._trajectory_states.items()},
        "landmark_ids": dict(pg._landmark_ids),
        "nodes_since_optimization": int(pg._nodes_since_optimization),
    }


def _restore_pose_graph_extras(pg: PoseGraph, z, meta: dict) -> None:
    pg.fixed_frame_observations = [
        (int(n), p.copy(), float(w))
        for n, p, w in zip(z["live/pg/ff_node"], z["live/pg/ff_pos"], z["live/pg/ff_weight"])]
    pg._landmark_ids = {k: int(v) for k, v in meta["landmark_ids"].items()}
    pg.landmark_observations = [
        (int(n[0]), int(n[1]), float(s[0]), int(lid), q.copy(), p.copy(), float(s[1]), float(s[2]))
        for n, lid, s, q, p in zip(z["live/pg/lm_nodes"], z["live/pg/lm_id"], z["live/pg/lm_scalars"],
                                   z["live/pg/lm_rot"], z["live/pg/lm_pos"])]
    pg.odometry_links = [(int(n[0]), int(n[1]), _arr_pose(p))
                         for n, p in zip(z["live/pg/odom_nodes"], z["live/pg/odom_pose"])]
    for s, fr, tr in zip(pg.submaps, z["live/pg/submap_frozen"], z["live/pg/submap_trimmed"]):
        s.frozen, s.trimmed = bool(fr), bool(tr)
    for i, (n, fr) in enumerate(zip(pg.nodes, z["live/pg/node_frozen"])):
        n.frozen = bool(fr)
        for f in _NODE_CLOUDS:
            setattr(n, f, z[f"live/node/{i}/{f}"])
    for c, score, yaw in zip(pg.constraints, z["live/pg/constraint_score"], z["live/pg/constraint_yaw"]):
        c.score, c.yaw_correction = float(score), float(yaw)
    if "live/pg/landmark_positions" in z:
        pg._last_landmark_positions = np.array(z["live/pg/landmark_positions"])
    for k, v in meta["trajectory_states"].items():
        pg._ensure_trajectory(int(k))
        pg._trajectory_states[int(k)] = v
    pg._nodes_since_optimization = int(meta["nodes_since_optimization"])


def _save_trajectory(tid: int, t, data: dict) -> dict:
    """One trajectory builder's live state: arrays into `data`, the rest
    returned for live_meta."""
    p = f"live/t{tid}/"

    def arrays(name, values, dtype, shape):
        data[p + name] = np.asarray(values, dtype).reshape(shape)

    arrays("imu_times", t._imu_times, np.float64, (-1,))
    arrays("imu_acc", t._imu_acc, np.float32, (-1, 3))
    arrays("imu_gyr", t._imu_gyr, np.float32, (-1, 3))
    arrays("init_acc", t._init_acc, np.float32, (-1, 3))
    arrays("init_gyr", t._init_gyr, np.float32, (-1, 3))
    arrays("ff_times", [x[0] for x in t._ff_buffer], np.float64, (-1,))
    arrays("ff_pos", [x[1] for x in t._ff_buffer], np.float32, (-1, 3))
    arrays("lm_times", [x[0] for x in t._lm_buffer], np.float64, (-1,))
    arrays("lm_pos", [x[2] for x in t._lm_buffer], np.float32, (-1, 3))
    odom = t._odom_buffer
    arrays("odom_times", odom._times, np.float64, (-1,))
    arrays("odom_rot", odom._rotations, np.float64, (-1, 4))
    arrays("odom_trans", odom._translations, np.float64, (-1, 3))
    for k, (pts, tms) in enumerate(zip(t._accum_points, t._accum_times)):
        data[p + f"accum/{k}/points"], data[p + f"accum/{k}/times"] = pts, tms
    sync = t._synchronizer
    sync_stamps = {}
    for sid, buf in sync._buffer.items():
        sync_stamps[sid] = [float(stamp) for stamp, _, _ in buf]
        for k, (_, pts, tms) in enumerate(buf):
            data[p + f"sync/{sid}/{k}/points"], data[p + f"sync/{sid}/{k}/times"] = pts, tms
    res = t._results
    arrays("results/time", [r["time"] for r in res], np.float64, (-1,))
    arrays("results/rotation", [r["local_pose"].rotation for r in res], np.float32, (-1, 4))
    arrays("results/translation", [r["local_pose"].translation for r in res], np.float32, (-1, 3))
    arrays("results/velocity", [r["velocity"] for r in res], np.float32, (-1, 3))
    arrays("results/flags", [(r["failed"], r["inserted"]) for r in res], bool, (-1, 2))
    if t._navsat is not None and t._navsat.anchored:
        data[p + "navsat_rot"], data[p + "navsat_trans"] = t._navsat.anchor()
    if t._initialized:
        for path, leaf in state_leaves(t._lio):
            data[p + "state/" + path] = leaf.detach().cpu().numpy()
    return {
        "initialized": bool(t._initialized),
        "init_frames": int(t._init_frames),
        "last_imu_time": _opt_float(t._last_imu_time),
        "time_origin": _opt_float(t._time_origin),
        "pg_submap_ids": [int(i) for i in t._pg_submap_ids],
        "prev_node": [int(t._prev_node[0]), float(t._prev_node[1])] if t._prev_node else None,
        "last_queue_time": dict(t._last_queue_time),
        "finished": bool(t.finished),
        "num_out_of_order_dropped": int(t.num_out_of_order_dropped),
        "sensor_ids": sync.sensor_ids,
        "sync_last_end": _opt_float(sync._last_end),
        "sync_stamps": sync_stamps,
        "lm_ids": [x[1] for x in t._lm_buffer],
        "num_accum": len(t._accum_points),
        "odom_limit": odom._limit,
    }


def save_live_checkpoint(path: str, builder, config_preset: str = "basic") -> None:
    """Mid-run checkpoint of a RUNNING MapBuilder: the map state (the
    pose-graph arrays of `save_state`) plus every trajectory's device state
    and host bookkeeping, so a restored builder continues ingesting
    mid-submap with the same results. Beyond the reference, whose pbstream
    serializes only the finished map (SURVEY §5).

    The pipelined fetch is read first (`flush`, which captures a submap's
    grids finished by the pending scan before the banks are copied), then
    the pool drains."""
    for tid, t in builder._trajectories.items():
        _refuse_unrestorable(tid, t)
    builder.flush()
    builder.pose_graph.wait_for_all_computations()
    data = _state_arrays(builder.pose_graph, config_preset)
    meta = {
        "format": LIVE_FORMAT,
        "pure_localization": bool(builder._pure_localization),
        "pose_graph": _pose_graph_extras(builder.pose_graph, data),
        "trajectories": {str(tid): _save_trajectory(tid, t, data)
                         for tid, t in builder._trajectories.items()},
    }
    data["live_meta"] = _json_blob(meta)
    np.savez_compressed(path, **data)


def _restore_state(tid: int, z, template):
    """The saved LioState of trajectory `tid`, each tensor checked against
    the template's shape, dtype and device."""
    prefix = f"live/t{tid}/state/"
    saved = {k[len(prefix):] for k in z.files if k.startswith(prefix)}
    values = {}
    for path, leaf in state_leaves(template):
        if path not in saved:
            raise ValueError(f"trajectory {tid}: the checkpoint has no state field {path}; restore "
                             "with the trajectory_builder configuration it was saved under")
        arr = z[prefix + path]
        want = str(leaf.dtype).replace("torch.", "")
        if tuple(arr.shape) != tuple(leaf.shape) or arr.dtype.name != want:
            raise ValueError(f"trajectory {tid}: state field {path} is {arr.dtype.name} "
                             f"{tuple(arr.shape)} in the checkpoint, {want} {tuple(leaf.shape)} "
                             "under this configuration")
        value = torch.from_numpy(np.array(arr)).to(leaf.device)
        if value.device != leaf.device:
            raise ValueError(f"trajectory {tid}: state field {path} restored on {value.device}, "
                             f"not {leaf.device}")
        values[path] = value
        saved.discard(path)
    if saved:
        raise ValueError(f"trajectory {tid}: state fields {sorted(saved)} are not in this "
                         "configuration's state")
    return _rebuild(template, values)


def _restore_trajectory(builder, tid: int, m: dict, z) -> None:
    from dliom_tpu_torch.frontend.lio import make_lio_state
    from dliom_tpu_torch.imu.preintegration import NavState
    from dliom_tpu_torch.io.geodesy import NavSatConverter
    from dliom_tpu_torch.map_builder import _TrajectoryBuilder

    p = f"live/t{tid}/"
    t = _TrajectoryBuilder(builder, tid, m["sensor_ids"], builder._use_native_collator)
    builder._trajectories[tid] = t
    t._initialized = bool(m["initialized"])
    t._init_frames = int(m["init_frames"])
    t._last_imu_time = m["last_imu_time"]
    t._time_origin = m["time_origin"]
    t._pg_submap_ids = list(m["pg_submap_ids"])
    t._prev_node = tuple(m["prev_node"]) if m["prev_node"] else None
    t._last_queue_time = dict(m["last_queue_time"])
    t.finished = bool(m["finished"])
    t.num_out_of_order_dropped = int(m["num_out_of_order_dropped"])
    t._imu_times = [float(x) for x in z[p + "imu_times"]]
    t._imu_acc = list(np.array(z[p + "imu_acc"]))
    t._imu_gyr = list(np.array(z[p + "imu_gyr"]))
    t._init_acc = list(np.array(z[p + "init_acc"]))
    t._init_gyr = list(np.array(z[p + "init_gyr"]))
    t._ff_buffer = [(float(a), b) for a, b in zip(z[p + "ff_times"], np.array(z[p + "ff_pos"]))]
    t._lm_buffer = [(float(a), lid, b) for a, lid, b in
                    zip(z[p + "lm_times"], m["lm_ids"], np.array(z[p + "lm_pos"]))]
    odom = t._odom_buffer
    odom._limit = m["odom_limit"]
    odom._times = [float(x) for x in z[p + "odom_times"]]
    odom._rotations = list(np.array(z[p + "odom_rot"]))
    odom._translations = list(np.array(z[p + "odom_trans"]))
    t._accum_points = [z[p + f"accum/{k}/points"] for k in range(m["num_accum"])]
    t._accum_times = [z[p + f"accum/{k}/times"] for k in range(m["num_accum"])]
    sync = t._synchronizer
    sync._last_end = m["sync_last_end"]
    sync._buffer = {sid: [(stamp, z[p + f"sync/{sid}/{k}/points"], z[p + f"sync/{sid}/{k}/times"])
                          for k, stamp in enumerate(stamps)]
                    for sid, stamps in m["sync_stamps"].items()}
    flags = z[p + "results/flags"]
    t._results = [
        {"time": float(time), "trajectory_id": tid, "local_pose": Rigid3(q.copy(), tr.copy()),
         "velocity": v.copy(), "failed": bool(f[0]), "inserted": bool(f[1])}
        for time, q, tr, v, f in zip(z[p + "results/time"], z[p + "results/rotation"],
                                     z[p + "results/translation"], z[p + "results/velocity"], flags)]
    if p + "navsat_rot" in z:
        t._navsat = NavSatConverter.from_anchor(z[p + "navsat_rot"], z[p + "navsat_trans"])
    if t._initialized:
        dev = builder.device
        zero = torch.zeros(3, dtype=torch.float32, device=dev)
        template = make_lio_state(builder.tb, NavState.identity(dev), zero, zero)
        t._lio = _restore_state(tid, z, template)


def restore_live_checkpoint(builder, path: str) -> None:
    """Restore a `save_live_checkpoint` file into `builder`, a MapBuilder
    made without a default trajectory: the map with its saved trajectory
    ids, the pose graph's live parts, then every trajectory builder."""
    z = np.load(path, allow_pickle=False)
    if "live_meta" not in z:
        raise ValueError(f"{path} holds no live checkpoint (no live_meta); load the map with "
                         "map_builder_from_state")
    meta = _read_json(z, "live_meta")
    if meta.get("format") != LIVE_FORMAT:
        raise ValueError(f"{path}: live checkpoint format {meta.get('format')!r}, not {LIVE_FORMAT!r} "
                         "(saved by another package); load its map with map_builder_from_state")
    pg = builder.pose_graph
    if pg.nodes or pg.submaps or builder._trajectories:
        raise ValueError("restore_live_checkpoint needs an empty MapBuilder "
                         "(create_default_trajectory=False)")
    load_state_into(pg, path, builder.config, keep_trajectory_ids=True)
    _restore_pose_graph_extras(pg, z, meta["pose_graph"])
    for tid_s, m in meta["trajectories"].items():
        _restore_trajectory(builder, int(tid_s), m, z)
    builder._pure_localization = bool(meta["pure_localization"])

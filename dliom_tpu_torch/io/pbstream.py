"""Cartographer pbstream WRITE-path interop.

Emits the reference's proto-stream container and message schema so reference
ecosystem tooling (`pbstream_3d_map_publisher_main.cc`,
`kaist/kitti_trajectory_from_pbstream.cc`, `read_constraints_from_pbsteam.cc`,
`cartographer/ground_truth` relation tools) can consume runs produced here.
The native checkpoint format stays the .npz of io/serialization.py; this is
an export surface.

Container (`cartographer/io/proto_stream.cc`): 8-byte little-endian magic
0x7b1d1f7b5bf501db, then per message an 8-byte little-endian size of the
gzip-compressed serialized proto followed by those bytes.

Message schema and order (`io/internal/mapping_state_serialization.cc:193-208`,
format version 1): SerializationHeader, SerializedData{pose_graph},
SerializedData{all_trajectory_builder_options}, then one SerializedData per
submap, node, and trajectory-data entry. Field numbers follow the reference
.proto files, cited per builder below (mapping/proto/serialization.proto,
pose_graph.proto, trajectory.proto, submap.proto, trajectory_node_data.proto,
3d/hybrid_grid.proto, sensor/proto/sensor.proto,
transform/proto/transform.proto). The encoder is a minimal hand-rolled
protobuf wire-format writer — no generated bindings, no proto runtime.

Port of dliom_tpu/io/pbstream.py: poses are the port's host `Rigid3`
(float64 numpy, composed with the `np_*` mirrors), node data stays numpy,
and finished submaps' compressed grids are tensors on the pose graph's
device, read back when written and loaded onto `pg.device` when read. The
messages equal the JAX package's field by field (gzip stamps the time into
each compressed record, so compare the decompressed blobs).
"""

from __future__ import annotations

import bisect
import gzip
import struct
import warnings
from typing import Iterable, List, Tuple

import numpy as np
import torch

from dliom_tpu_torch.sensor import compressed_point_cloud as cpc
from dliom_tpu_torch.transform.rigid import (
    Rigid3,
    np_compose,
    np_inverse,
    np_quat_rotate,
    np_rigid,
)

MAGIC = 0x7B1D1F7B5BF501DB
FORMAT_VERSION = 1  # io/internal/mapping_state_serialization.h:27
# common/time.h:29 — seconds between 0001-01-01 (UTS epoch) and 1970-01-01
UTS_EPOCH_OFFSET_SECONDS = 719162 * 24 * 60 * 60
UTS_TICKS_PER_SECOND = 10_000_000  # 100 ns resolution


def to_universal_ticks(unix_seconds: float) -> int:
    """common::ToUniversal of a unix timestamp. The epoch offset is applied
    in INTEGER ticks: at UTS scale (~6.4e17 ticks) float64 only resolves
    ~100 ticks, which would corrupt sub-microsecond stamps."""
    return (
        int(round(unix_seconds * UTS_TICKS_PER_SECOND))
        + UTS_EPOCH_OFFSET_SECONDS * UTS_TICKS_PER_SECOND
    )


def from_universal_ticks(ticks: int) -> float:
    return (
        ticks - UTS_EPOCH_OFFSET_SECONDS * UTS_TICKS_PER_SECOND
    ) / UTS_TICKS_PER_SECOND


# ---------------------------------------------------------------------------
# Protobuf wire-format primitives (proto3)
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    if value < 0:  # proto int32/int64 negative values use 10-byte varints
        value += 1 << 64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(value: int) -> int:
    return (value << 1) ^ (value >> 63)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def fv(field: int, value: int) -> bytes:
    """Varint-typed field (int32/int64/uint32/bool/enum); 0 is omitted
    (proto3 default)."""
    if value == 0:
        return b""
    return _tag(field, 0) + _varint(int(value))


def fd(field: int, value: float) -> bytes:
    """double field; 0.0 omitted."""
    if value == 0.0:
        return b""
    return _tag(field, 1) + struct.pack("<d", float(value))


def ff32(field: int, value: float) -> bytes:
    """float field; 0.0 omitted."""
    if value == 0.0:
        return b""
    return _tag(field, 5) + struct.pack("<f", float(value))


def fm(field: int, payload: bytes, keep_empty: bool = False) -> bytes:
    """Length-delimited submessage/string/bytes field."""
    if not payload and not keep_empty:
        return b""
    return _tag(field, 2) + _varint(len(payload)) + payload


def fs(field: int, value: str) -> bytes:
    return fm(field, value.encode("utf-8"))


def packed_varints(field: int, values: Iterable[int], zigzag: bool = False) -> bytes:
    body = b"".join(
        _varint(_zigzag(int(v)) if zigzag else int(v)) for v in values
    )
    return fm(field, body)


def packed_floats(field: int, values: Iterable[float]) -> bytes:
    body = b"".join(struct.pack("<f", float(v)) for v in values)
    return fm(field, body)


# ---------------------------------------------------------------------------
# Reference message builders (field numbers cited per .proto)
# ---------------------------------------------------------------------------


def _vector3d(t) -> bytes:
    # transform.proto Vector3d: x=1, y=2, z=3 (double)
    return fd(1, float(t[0])) + fd(2, float(t[1])) + fd(3, float(t[2]))


def _quaterniond(q) -> bytes:
    # transform.proto Quaterniond: x=1, y=2, z=3, w=4 — note the repo's
    # quaternions are (w, x, y, z)
    w, x, y, z = (float(v) for v in q)
    return fd(1, x) + fd(2, y) + fd(3, z) + fd(4, w)


def _rigid3d(pose) -> bytes:
    # transform.proto Rigid3d: translation=1 (Vector3d), rotation=2 (Quaterniond)
    return fm(1, _vector3d(np.asarray(pose.translation))) + fm(
        2, _quaterniond(np.asarray(pose.rotation))
    )


def _submap_id(trajectory_id: int, submap_index: int) -> bytes:
    # pose_graph.proto SubmapId: trajectory_id=1, submap_index=2
    return fv(1, trajectory_id) + fv(2, submap_index)


def _node_id(trajectory_id: int, node_index: int) -> bytes:
    # pose_graph.proto NodeId: trajectory_id=1, node_index=2
    return fv(1, trajectory_id) + fv(2, node_index)


def _compressed_point_cloud(points: np.ndarray) -> bytes:
    """sensor.proto CompressedPointCloud: num_points=1, point_data=3
    (packed int32). Layout per block (compressed_point_cloud.cc:128-146):
    [count, block_x, block_y, block_z, packed_points...]."""
    c = cpc.compress(np.asarray(points, np.float32).reshape(-1, 3))
    data: List[int] = []
    pos = 0
    for b in range(c.block_origins.shape[0]):
        n = int(c.block_counts[b])
        bx, by, bz = (int(v) >> cpc.BITS for v in c.block_origins[b])
        data.extend((n, bx, by, bz))
        data.extend(int(v) for v in c.packed[pos : pos + n])
        pos += n
    return fv(1, int(c.num_points)) + packed_varints(3, data)


def _hybrid_grid(indices: np.ndarray, values: np.ndarray, resolution: float) -> bytes:
    """mapping/proto/3d/hybrid_grid.proto: resolution=1,
    x_indices=3/y=4/z=5 (packed sint32), values=6 (packed int32)."""
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    return (
        ff32(1, resolution)
        + packed_varints(3, idx[:, 0], zigzag=True)
        + packed_varints(4, idx[:, 1], zigzag=True)
        + packed_varints(5, idx[:, 2], zigzag=True)
        + packed_varints(6, np.asarray(values, np.int64))
    )


def _pose_graph_proto(pg) -> bytes:
    """mapping/proto/pose_graph.proto PoseGraph: constraint=2,
    trajectory=4, landmark_poses=5."""
    out = b""
    # constraints (Constraint: submap_id=1, node_id=2, relative_pose=3,
    # tag=5 [INTRA_SUBMAP=0, INTER_SUBMAP=1], translation_weight=6,
    # rotation_weight=7)
    sub_index = _per_trajectory_indices(pg)
    node_index = _node_indices(pg)
    for c in pg.constraints:
        body = (
            fm(1, _submap_id(*sub_index[c.submap_id]))
            + fm(2, _node_id(*node_index[c.node_id]))
            + fm(3, _rigid3d(c.relative))
            + fv(5, 1 if c.tag == "INTER" else 0)
            + fd(6, c.translation_weight)
            + fd(7, c.rotation_weight)
        )
        out += fm(2, body, keep_empty=True)
    # trajectories (trajectory.proto Trajectory: node=1, submap=2,
    # trajectory_id=3; Node: timestamp=1, pose=5, node_index=7;
    # Submap: pose=1, submap_index=2)
    tids = sorted(
        {s.trajectory_id for s in pg.submaps}
        | {n.trajectory_id for n in pg.nodes}
    )
    for tid in tids:
        body = fv(3, tid)
        for nid, n in enumerate(pg.nodes):
            if n.trajectory_id != tid:
                continue
            node_body = (
                fv(1, to_universal_ticks(n.time))
                + fm(5, _rigid3d(n.global_pose))
                + fv(7, node_index[nid][1])
            )
            body += fm(1, node_body, keep_empty=True)
        for sid, s in enumerate(pg.submaps):
            if s.trajectory_id != tid:
                continue
            body += fm(
                2,
                fm(1, _rigid3d(s.global_pose)) + fv(2, sub_index[sid][1]),
                keep_empty=True,
            )
        out += fm(4, body, keep_empty=True)
    # landmark poses (LandmarkPose: landmark_id=1, global_pose=2)
    for name, position in pg.landmark_poses().items():
        pose = Rigid3(_IDENTITY_Q, np.asarray(position, np.float64))
        out += fm(5, fs(1, name) + fm(2, _rigid3d(pose)))
    return out


_IDENTITY_Q = np.asarray([1.0, 0.0, 0.0, 0.0])


def _per_trajectory_indices(pg) -> List[Tuple[int, int]]:
    return [(s.trajectory_id, s.index_in_trajectory) for s in pg.submaps]


def _node_indices(pg) -> List[Tuple[int, int]]:
    counters: dict = {}
    out = []
    for n in pg.nodes:
        k = counters.get(n.trajectory_id, 0)
        counters[n.trajectory_id] = k + 1
        out.append((n.trajectory_id, k))
    return out


class PbstreamWriter:
    """ProtoStreamWriter analog (proto_stream.cc:46-67)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(struct.pack("<Q", MAGIC))

    def write(self, serialized: bytes) -> None:
        compressed = gzip.compress(serialized)
        self._f.write(struct.pack("<Q", len(compressed)))
        self._f.write(compressed)

    def close(self) -> None:
        self._f.close()


class PbstreamReader:
    """ProtoStreamReader analog — validates the magic, yields message
    blobs (used by the round-trip tests; reference tools are the real
    consumers)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        (magic,) = struct.unpack("<Q", self._f.read(8))
        if magic != MAGIC:
            raise ValueError(f"not a pbstream: bad magic {magic:#x}")

    def __iter__(self):
        while True:
            header = self._f.read(8)
            if len(header) < 8:
                return
            (size,) = struct.unpack("<Q", header)
            yield gzip.decompress(self._f.read(size))

    def close(self) -> None:
        self._f.close()


def write_pbstream(path: str, pg, include_grids: bool = True) -> None:
    """WritePbStream (mapping_state_serialization.cc:193-208): header,
    pose graph, trajectory builder options, submaps, nodes, trajectory
    data. `pg` is a backend.pose_graph.PoseGraph."""

    def cell_coordinates(lin: np.ndarray, spec) -> np.ndarray:
        """Inverse of mapping.grid.linear_index: flat -> signed (N, 3)."""
        lin = np.asarray(lin, np.int64)
        e, h = spec.extent, spec.half
        return np.stack(
            [lin // (e * e) - h, (lin // e) % e - h, lin % e - h], axis=-1
        )

    w = PbstreamWriter(path)
    # SerializationHeader (serialization.proto): format_version=1
    w.write(fv(1, FORMAT_VERSION))
    # SerializedData oneof fields (serialization.proto): pose_graph=1,
    # all_trajectory_builder_options=2, submap=3, node=4, trajectory_data=5
    w.write(fm(1, _pose_graph_proto(pg), keep_empty=True))
    tids = sorted(
        {s.trajectory_id for s in pg.submaps}
        | {n.trajectory_id for n in pg.nodes}
    )
    # AllTrajectoryBuilderOptions: options_with_sensor_ids=1, one (empty =
    # all-defaults) entry per trajectory — LoadState indexes it by count
    opts = b"".join(fm(1, b"", keep_empty=True) for _ in tids)
    w.write(fm(2, opts, keep_empty=True))

    sub_index = _per_trajectory_indices(pg)
    node_index = _node_indices(pg)
    hi_spec, lo_spec = pg._hi_spec, pg._lo_spec
    for sid, s in enumerate(pg.submaps):
        # Submap (serialization.proto): submap_id=1, submap_3d=3;
        # Submap3D (submap.proto): local_pose=1, num_range_data=2,
        # finished=3, high_resolution_hybrid_grid=4, low_..._grid=5
        body = fm(1, _submap_id(*sub_index[sid]))
        sub3d = (
            fm(1, _rigid3d(s.local_pose))
            + fv(2, len(s.node_ids))
            + fv(3, 1 if s.finished else 0)
        )
        if include_grids and s.high is not None:
            for field, comp, spec in ((4, s.high, hi_spec), (5, s.low, lo_spec)):
                count = int(comp.count)
                idx = cell_coordinates(pg._host(comp.indices), spec)[:count]
                vals = pg._host(comp.values)[:count]
                sub3d += fm(
                    field, _hybrid_grid(idx, vals, spec.resolution),
                    keep_empty=True,
                )
        body += fm(3, sub3d, keep_empty=True)
        w.write(fm(3, body, keep_empty=True))

    for nid, n in enumerate(pg.nodes):
        # Node (serialization.proto): node_id=1, node_data=5;
        # TrajectoryNodeData (trajectory_node_data.proto): timestamp=1,
        # gravity_alignment=2, high_resolution_point_cloud=4,
        # low_resolution_point_cloud=5, rotational_scan_matcher_histogram=6,
        # local_pose=7
        hi_pts = np.asarray(n.high_points)[np.asarray(n.high_mask)]
        lo_pts = np.asarray(n.low_points)[np.asarray(n.low_mask)]
        node_data = (
            fv(1, to_universal_ticks(n.time))
            + fm(2, _quaterniond(np.asarray(n.gravity_alignment)))
            + fm(4, _compressed_point_cloud(hi_pts), keep_empty=True)
            + fm(5, _compressed_point_cloud(lo_pts), keep_empty=True)
            + packed_floats(6, np.asarray(n.histogram))
            + fm(7, _rigid3d(n.local_pose))
        )
        body = fm(1, _node_id(*node_index[nid])) + fm(5, node_data, keep_empty=True)
        w.write(fm(4, body, keep_empty=True))

    for tid in tids:
        # TrajectoryData (serialization.proto): trajectory_id=1,
        # gravity_constant=2, imu_calibration=3
        body = fv(1, tid) + fd(2, 9.80511) + fm(
            3, _quaterniond(np.asarray([1.0, 0.0, 0.0, 0.0]))
        )
        w.write(fm(5, body, keep_empty=True))

    # ---- sensor streams, in the reference's order
    # (mapping_state_serialization.cc:206-209: imu, odometry, fixed-frame,
    # landmarks). IMU is intentionally absent: the raw stream lives in the
    # frontend and the reference's 3D SPA IMU costs are commented out, so a
    # serialized IMU stream would be inert on load anyway.

    # OdometryData (serialization.proto:42): trajectory_id=1, sensor
    # OdometryData{timestamp=1, pose=2}=2. The raw stream is consumed at
    # ingest; re-synthesize an equivalent stream by chaining the retained
    # inter-node relatives from identity — sampled exactly at node times,
    # CalculateOdometryBetweenNodes recovers the identical relatives.
    chains: dict = {}
    for prev, nid, rel in pg.odometry_links:
        t = pg.nodes[nid].trajectory_id
        chains.setdefault(t, []).append((prev, nid, rel))
    for t, links in chains.items():
        links.sort(key=lambda x: x[1])
        cur = Rigid3(_IDENTITY_Q, np.zeros(3))
        emitted = set()
        last_nid = None
        for prev, nid, rel in links:
            if last_nid is not None and prev != last_nid:
                # coverage gap (odometry dropout between last_nid and prev):
                # bridge with the frontend's local-pose relative so a
                # consumer interpolating across the gap sees the SLAM-
                # estimated motion, not a fabricated zero motion
                bridge = np_compose(
                    np_inverse(np_rigid(pg.nodes[last_nid].local_pose)),
                    np_rigid(pg.nodes[prev].local_pose),
                )
                cur = np_compose(cur, bridge)
            for node_id, pose in ((prev, cur), (nid, np_compose(cur, np_rigid(rel)))):
                if node_id not in emitted:
                    body = fv(1, to_universal_ticks(pg.nodes[node_id].time)) + fm(
                        2, _rigid3d(pose)
                    )
                    w.write(fm(7, fv(1, t) + fm(2, body, keep_empty=True), keep_empty=True))
                    emitted.add(node_id)
            cur = np_compose(cur, np_rigid(rel))
            last_nid = nid

    # FixedFramePoseData (serialization.proto:47): GPS observations at node
    # stamps, translation-only poses (sensor_bridge navsat convention)
    for nid, pos, _w in pg.fixed_frame_observations:
        n = pg.nodes[nid]
        body = fv(1, to_universal_ticks(n.time)) + fm(
            2,
            fm(1, _vector3d(np.asarray(pos, np.float64)))
            + fm(2, _quaterniond(np.asarray([1.0, 0.0, 0.0, 0.0]))),
        )
        w.write(
            fm(8, fv(1, n.trajectory_id) + fm(2, body, keep_empty=True), keep_empty=True)
        )

    # LandmarkData (serialization.proto:52): one observation per message
    # (SerializeLandmarkNodes), landmark_to_tracking at the attachment node
    lid_to_name = {v: k for k, v in pg._landmark_ids.items()}
    for (n0, n1, alpha, lid, rq, pos, tw, rw) in pg.landmark_observations:
        n = pg.nodes[n1]
        obs = (
            fm(1, lid_to_name.get(lid, str(lid)).encode(), keep_empty=True)
            + fm(
                2,
                fm(1, _vector3d(np.asarray(pos, np.float64)))
                + fm(2, _quaterniond(np.asarray(rq, np.float64))),
            )
            + fd(3, tw)
            + fd(4, rw)
        )
        body = fv(1, to_universal_ticks(n.time)) + fm(2, obs, keep_empty=True)
        w.write(
            fm(9, fv(1, n.trajectory_id) + fm(2, body, keep_empty=True), keep_empty=True)
        )
    w.close()


# ---------------------------------------------------------------------------
# READ path: parse reference-schema pbstreams back into a PoseGraph
# (MapBuilder::LoadState over io/proto_stream.cc input — maps produced by
# cartographer tooling import directly).
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int):
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def parse_message(buf: bytes) -> dict:
    """Generic wire-format parse: {field: [(wire_type, raw_value), ...]}.
    Varints come out unsigned; length-delimited as bytes; 32/64-bit as raw
    little-endian bytes."""
    out: dict = {}
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v, i = buf[i : i + 8], i + 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i : i + ln], i + ln
        elif wt == 5:
            v, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(field, []).append((wt, v))
    return out


def _first(msg: dict, field: int, default=None):
    vals = msg.get(field)
    return vals[0][1] if vals else default


def _double(msg: dict, field: int, default=0.0) -> float:
    v = _first(msg, field)
    return struct.unpack("<d", v)[0] if v is not None else default


def _float(msg: dict, field: int, default=0.0) -> float:
    v = _first(msg, field)
    return struct.unpack("<f", v)[0] if v is not None else default


def _varint_field(msg: dict, field: int, default=0) -> int:
    v = _first(msg, field)
    return int(v) if v is not None else default


def _packed_varints(msg: dict, field: int, zigzag=False):
    out: List[int] = []
    for wt, raw in msg.get(field, []):
        if wt == 0:  # unpacked repeated
            out.append(int(raw))
        else:
            i = 0
            while i < len(raw):
                v, i = _read_varint(raw, i)
                out.append(v)
    if zigzag:
        return [_unzigzag(v) for v in out]
    # sint32 range wrap for plain int32 fields
    return [_signed64(v) for v in out]


def _packed_floats(msg: dict, field: int):
    out: List[float] = []
    for wt, raw in msg.get(field, []):
        if wt == 5:
            out.append(struct.unpack("<f", raw)[0])
        else:
            out.extend(
                struct.unpack(f"<{len(raw) // 4}f", raw)
            )
    return out


def _parse_quat(qm: dict):
    """proto Quaterniond (x=1, y=2, z=3, w=4) -> (w, x, y, z) list.

    proto3 zero-skipping: an absent component is 0.0 (so w=0 quaternions —
    180° rotations — read back correctly); a fully-absent message means an
    unset rotation -> identity."""
    if not qm:
        return [1.0, 0.0, 0.0, 0.0]
    return [_double(qm, 4), _double(qm, 1), _double(qm, 2), _double(qm, 3)]


def _parse_rigid3d(raw: bytes) -> Rigid3:
    """proto Rigid3d -> the port's host Rigid3 (float64)."""
    m = parse_message(raw)
    t_raw = _first(m, 1, b"")
    q_raw = _first(m, 2, b"")
    tm = parse_message(t_raw) if t_raw else {}
    qm = parse_message(q_raw) if q_raw else {}
    t = [_double(tm, 1), _double(tm, 2), _double(tm, 3)]
    q = _parse_quat(qm)
    return Rigid3(np.asarray(q, np.float64), np.asarray(t, np.float64))


def _parse_id(raw: bytes):
    m = parse_message(raw)
    return _varint_field(m, 1), _varint_field(m, 2)  # (trajectory, index)


def _parse_compressed_cloud(raw: bytes, capacity: int):
    """Reference CompressedPointCloud -> (points (capacity, 3) f32, mask)."""
    m = parse_message(raw)
    data = _packed_varints(m, 3)
    pts = []
    i = 0
    while i < len(data):
        cnt, bx, by, bz = data[i : i + 4]
        i += 4
        for p in data[i : i + cnt]:
            pts.append(
                (
                    ((p & 1023) + (bx << 10)) * 0.001,
                    (((p >> 10) & 1023) + (by << 10)) * 0.001,
                    (((p >> 20) & 1023) + (bz << 10)) * 0.001,
                )
            )
        i += cnt
    out = np.zeros((capacity, 3), np.float32)
    n = len(pts)
    k = min(n, capacity)
    if n > capacity:
        # uniform subsample, not a prefix: the compressed stream is
        # block-Morton ordered, so a prefix would keep one spatial corner of
        # the scan (pad_point_cloud's convention; surfaced, never silent)
        warnings.warn(
            f"pbstream node cloud has {n} points > capacity {capacity}; "
            "uniformly subsampling (raise the trajectory_builder point "
            "capacities to keep all)",
            stacklevel=2,
        )
        arr = np.asarray(pts, np.float32)
        idx = np.linspace(0, n - 1, capacity).round().astype(np.int64)
        out[:] = arr[idx]
    elif k:
        out[:k] = np.asarray(pts, np.float32)
    return out, np.arange(capacity) < k


def load_pbstream_into(pg, path: str, frozen: bool = False) -> dict:
    """Append a reference-schema pbstream's state to a PoseGraph
    (MapBuilder::LoadState, map_builder.cc:209-367): trajectories remap to
    fresh ids, submap grids recompress into the backend's sparse form,
    constraints re-link. Grids go onto `pg.device`; node data stays host
    numpy. Returns {loaded_tid: new_tid}."""
    from dliom_tpu_torch.backend.compression import CompressedGrid
    from dliom_tpu_torch.backend.pose_graph import Constraint, NodeRecord, SubmapRecord
    from dliom_tpu_torch.mapping.grid import linear_index
    from dliom_tpu_torch.ops.rotational_histogram import compute_histogram

    hi_spec, lo_spec = pg._hi_spec, pg._lo_spec
    tb = pg.tb_cfg
    blobs = list(PbstreamReader(path))
    header = parse_message(blobs[0])
    if _varint_field(header, 1) != FORMAT_VERSION:
        raise ValueError(
            f"unsupported pbstream format version {_varint_field(header, 1)}"
        )
    tid_map: dict = {}

    def map_tid(t: int) -> int:
        if t not in tid_map:
            tid_map[t] = pg.add_trajectory(frozen=frozen)
        return tid_map[t]

    # pass 1: the PoseGraph message provides global poses + constraints
    pose_graph_msg = parse_message(blobs[1])
    data_kind = next(iter(pose_graph_msg))
    assert data_kind == 1, "pose_graph must be the first SerializedData"
    pgp = parse_message(_first(pose_graph_msg, 1))
    global_sub = {}
    global_node = {}
    node_times = {}
    for _, raw in pgp.get(4, []):  # trajectories
        tm = parse_message(raw)
        tid = _varint_field(tm, 3)
        for _, nraw in tm.get(1, []):
            nm = parse_message(nraw)
            idx = _varint_field(nm, 7)
            global_node[(tid, idx)] = _parse_rigid3d(_first(nm, 5, b""))
            node_times[(tid, idx)] = from_universal_ticks(
                _signed64(_varint_field(nm, 1))
            )
        for _, sraw in tm.get(2, []):
            sm = parse_message(sraw)
            idx = _varint_field(sm, 2)
            global_sub[(tid, idx)] = _parse_rigid3d(_first(sm, 1, b""))

    sub_ids: dict = {}
    node_ids: dict = {}

    def grid_from_proto(raw: bytes, spec, capacity: int):
        g = parse_message(raw)
        xs = _packed_varints(g, 3, zigzag=True)
        ys = _packed_varints(g, 4, zigzag=True)
        zs = _packed_varints(g, 5, zigzag=True)
        vals = np.asarray(_packed_varints(g, 6), np.int32)
        cells = torch.from_numpy(np.stack([xs, ys, zs], -1).astype(np.int32).reshape(-1, 3))
        lin, ok = linear_index(cells, spec)
        ok = ok.numpy()
        lin = lin.numpy()[ok][:capacity]
        vals = vals[ok][:capacity]
        order = np.argsort(lin)
        pad = capacity - len(lin)
        idx = np.concatenate(
            [lin[order], np.full(pad, spec.num_cells, np.int32)]
        )
        vv = np.concatenate([vals[order], np.zeros(pad, np.int32)])
        return CompressedGrid(
            indices=torch.from_numpy(idx.astype(np.int32)).to(pg.device),
            values=torch.from_numpy(vv.astype(np.int16)).to(pg.device),
            count=torch.tensor(len(lin), dtype=torch.int32, device=pg.device),
        )

    # pass 2: submaps and nodes, in stream order
    ff_msgs: list = []  # (local tid, time, position)
    lm_msgs: list = []  # (local tid, time, name, rq, pos, tw, rw)
    odo_msgs: list = []  # (local tid, time, Rigid3)
    for blob in blobs[2:]:
        m = parse_message(blob)
        kind = next(iter(m))
        if kind == 3:  # Submap
            sm = parse_message(_first(m, 3))
            tid_l, idx = _parse_id(_first(sm, 1, b""))
            s3 = parse_message(_first(sm, 3, b""))
            local_pose = _parse_rigid3d(_first(s3, 1, b""))
            rec = SubmapRecord(
                local_pose=local_pose,
                global_pose=global_sub.get((tid_l, idx), local_pose),
                finished=bool(_varint_field(s3, 3)),
                histogram=np.zeros(pg._num_histogram, np.float32),
                trajectory_id=map_tid(tid_l),
                index_in_trajectory=idx,
                frozen=frozen,
            )
            if _first(s3, 4) is not None:
                rec.high = grid_from_proto(
                    _first(s3, 4), hi_spec, pg._compress_capacity
                )
            if _first(s3, 5) is not None:
                rec.low = grid_from_proto(
                    _first(s3, 5), lo_spec, pg.low_compress_capacity
                )
            tid = rec.trajectory_id
            pg._traj_submap_counts[tid] = max(
                pg._traj_submap_counts.get(tid, 0), idx + 1
            )
            sub_ids[(tid_l, idx)] = len(pg.submaps)
            pg.submaps.append(rec)
        elif kind == 4:  # Node
            nm = parse_message(_first(m, 4))
            tid_l, idx = _parse_id(_first(nm, 1, b""))
            nd = parse_message(_first(nm, 5, b""))
            local_pose = _parse_rigid3d(_first(nd, 7, b""))
            qm = parse_message(_first(nd, 2, b""))
            grav = np.asarray(_parse_quat(qm), np.float32)
            hi_pts, hi_mask = _parse_compressed_cloud(
                _first(nd, 4, b""), tb.max_high_res_points
            )
            lo_pts, lo_mask = _parse_compressed_cloud(
                _first(nd, 5, b""), tb.max_low_res_points
            )
            hist = np.asarray(_packed_floats(nd, 6), np.float32)
            if hist.size != pg._num_histogram:
                # re-derive at our configured bin count
                hist = compute_histogram(
                    torch.from_numpy(hi_pts), torch.from_numpy(hi_mask),
                    pg._num_histogram,
                ).numpy()
            node_ids[(tid_l, idx)] = len(pg.nodes)
            pg.nodes.append(
                NodeRecord(
                    time=node_times.get((tid_l, idx), 0.0),
                    local_pose=local_pose,
                    global_pose=global_node.get((tid_l, idx), local_pose),
                    gravity_alignment=grav,
                    high_points=hi_pts,
                    high_mask=hi_mask,
                    low_points=lo_pts,
                    low_mask=lo_mask,
                    histogram=hist,
                    submap_ids=(),
                    frozen=frozen,
                    trajectory_id=map_tid(tid_l),
                )
            )
        elif kind == 7:  # OdometryData
            om_ = parse_message(_first(m, 7))
            tid_l = _varint_field(om_, 1)
            body = parse_message(_first(om_, 2, b""))
            t = from_universal_ticks(_signed64(_varint_field(body, 1)))
            odo_msgs.append((tid_l, t, _parse_rigid3d(_first(body, 2, b""))))
        elif kind == 8:  # FixedFramePoseData (GPS)
            fm_ = parse_message(_first(m, 8))
            tid_l = _varint_field(fm_, 1)
            body = parse_message(_first(fm_, 2, b""))
            t = from_universal_ticks(_signed64(_varint_field(body, 1)))
            rp = parse_message(_first(body, 2, b""))
            tv = parse_message(_first(rp, 1, b""))
            pos = np.asarray(
                [_double(tv, 1), _double(tv, 2), _double(tv, 3)], np.float64
            )
            ff_msgs.append((tid_l, t, pos))
        elif kind == 9:  # LandmarkData
            lm = parse_message(_first(m, 9))
            tid_l = _varint_field(lm, 1)
            body = parse_message(_first(lm, 2, b""))
            t = from_universal_ticks(_signed64(_varint_field(body, 1)))
            for _, oraw in body.get(2, []):
                om = parse_message(oraw)
                name = _first(om, 1, b"").decode("utf-8", "replace")
                rp = parse_message(_first(om, 2, b""))
                tv = parse_message(_first(rp, 1, b""))
                qm2 = parse_message(_first(rp, 2, b""))
                pos = np.asarray(
                    [_double(tv, 1), _double(tv, 2), _double(tv, 3)],
                    np.float64,
                )
                rq = np.asarray(_parse_quat(qm2), np.float64)
                # proto3 zero-skip: absent weights are 0.0, NOT 1.0 — a
                # weight-0 (disabled) cost must stay disabled on import
                lm_msgs.append(
                    (tid_l, t, name, rq, pos, _double(om, 3),
                     _double(om, 4))
                )

    # sensor streams attach to the nearest-in-time node of their trajectory
    # (the reference re-feeds MapByTime streams into the optimization
    # problem, which associates them to bracketing nodes the same way)
    by_traj: dict = {}
    for (tid_l, idx), nid in node_ids.items():
        by_traj.setdefault(tid_l, []).append(
            (node_times.get((tid_l, idx), 0.0), nid)
        )
    for v in by_traj.values():
        v.sort()

    def _nearest_node(tid_l: int, t: float):
        times = by_traj.get(tid_l)
        if not times:
            return None
        i = bisect.bisect_left(times, (t, -1))
        cands = [j for j in (i - 1, i) if 0 <= j < len(times)]
        best = min(cands, key=lambda j: abs(times[j][0] - t))
        return times[best][1]

    # odometry: rebuild consecutive-node links via interpolation at node
    # stamps (CalculateOdometryBetweenNodes — exactly what the reference's
    # LoadState-fed optimization problem does with the stream)
    if odo_msgs:
        from dliom_tpu_torch.transform.interpolation import TransformInterpolationBuffer

        bufs: dict = {}
        for tid_l, t, pose in sorted(odo_msgs, key=lambda x: (x[0], x[1])):
            buf = bufs.setdefault(tid_l, TransformInterpolationBuffer())
            if len(buf) and t <= buf.latest_time:
                continue
            buf.push(t, pose)
        for tid_l, buf in bufs.items():
            times = by_traj.get(tid_l, [])
            for (t0, n0), (t1, n1) in zip(times, times[1:]):
                if buf.has(t0) and buf.has(t1):
                    p0, p1 = buf.lookup(t0), buf.lookup(t1)
                    pg.odometry_links.append(
                        (n0, n1, np_compose(np_inverse(np_rigid(p0)), np_rigid(p1)))
                    )

    for tid_l, t, pos in ff_msgs:
        nid = _nearest_node(tid_l, t)
        if nid is not None:
            pg.add_fixed_frame_pose(nid, pos)
    for tid_l, t, name, rq, pos, tw, rw in lm_msgs:
        nid = _nearest_node(tid_l, t)
        if nid is not None:
            pg.add_landmark_observation(
                nid, name, pos, weight=tw,
                rotation_in_tracking=rq, rotation_weight=rw,
            )

    # pass 3: constraints (now that both id spaces resolve)
    for _, raw in pgp.get(2, []):
        cm = parse_message(raw)
        sid_l = _parse_id(_first(cm, 1, b""))
        nid_l = _parse_id(_first(cm, 2, b""))
        if sid_l not in sub_ids or nid_l not in node_ids:
            continue  # trimmed endpoints (reference drops them too)
        tag = "INTER" if _varint_field(cm, 5) == 1 else "INTRA"
        c = Constraint(
            submap_id=sub_ids[sid_l],
            node_id=node_ids[nid_l],
            relative=_parse_rigid3d(_first(cm, 3, b"")),
            translation_weight=_double(cm, 6),
            rotation_weight=_double(cm, 7),
            tag=tag,
        )
        pg.constraints.append(c)
        if tag == "INTRA":
            pg.submaps[c.submap_id].node_ids.append(c.node_id)
            node = pg.nodes[c.node_id]
            node.submap_ids = tuple(node.submap_ids) + (c.submap_id,)
    pg.reindex_constraints()
    for c in pg.constraints:
        if c.tag == "INTER":
            t_sub = pg.submaps[c.submap_id].trajectory_id
            t_node = pg.nodes[c.node_id].trajectory_id
            if t_sub != t_node:
                pg.connect_trajectories(
                    t_sub, t_node, pg.nodes[c.node_id].time
                )
    return tid_map


def _vector3f(t) -> bytes:
    # transform.proto Vector3f: x=1, y=2, z=3 (float)
    return ff32(1, float(t[0])) + ff32(2, float(t[1])) + ff32(3, float(t[2]))


def write_range_data_pbstream(path: str, pg) -> None:
    """D-LIOM's second artifact: per-node range data in the LOCAL frame
    (MapBuilderBridge::SerializeRangeData, map_builder_bridge.cc:170-201;
    mapping/proto/local_slam_range_data.proto NodeRangeData) — consumed by
    the reference's offline map viewer (`pb_range_data_to_ros_cloud`).
    Stream layout mirrors the reference: SerializationHeader, then one
    NodeRangeData message per node."""
    w = PbstreamWriter(path)
    w.write(fv(1, FORMAT_VERSION))
    node_index = _node_indices(pg)
    for nid, n in enumerate(pg.nodes):
        pts = np.asarray(n.high_points)[np.asarray(n.high_mask)]
        # tracking frame -> local frame, on the host pose
        pose = np_rigid(n.local_pose)
        local = np_quat_rotate(pose.rotation, pts.astype(np.float64)) + pose.translation if len(pts) else pts
        origin = pose.translation
        # RangeData (sensor.proto): origin=1, returns=2 (repeated Vector3f)
        range_pb = fm(1, _vector3f(origin), keep_empty=True) + b"".join(
            fm(2, _vector3f(p), keep_empty=True) for p in local
        )
        tid, idx = node_index[nid]
        # NodeRangeData: timestamp=1, trajectory_id=2, node_index=3,
        # local_pose=4, range_data_in_local=5
        body = (
            fv(1, to_universal_ticks(n.time))
            + fv(2, tid)
            + fv(3, idx)
            + fm(4, _rigid3d(n.local_pose))
            + fm(5, range_pb, keep_empty=True)
        )
        w.write(body)
    w.close()

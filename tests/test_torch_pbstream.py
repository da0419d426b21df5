"""Cartographer pbstream interop of the port (dliom_tpu_torch/io/pbstream.py)
against the JAX package (dliom_tpu/io/pbstream.py).

gzip stamps the time into every compressed record, so two files never match
byte for byte: the decompressed messages are compared, field by field
(integers, ids, grid cells and values and packed clouds exact, doubles and
floats within 1e-6; the port's host poses are float64 where the JAX
package's are float32). Held: both writers on the same graph (with
fixed-frame, landmark and odometry streams) and both range-data writers;
`load_pbstream_into` of tests/fixtures/reference_map.pbstream gives equal
records in both packages; the port localizes a live revisit against that
fixture on the CPU as tests/test_pbstream.py does; the port's own write /
read round trip, sensor streams included, and `map_builder_from_state` on a
.pbstream.
"""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.backend.pose_graph import PoseGraph as JPoseGraph
from dliom_tpu.io import pbstream as JP
from dliom_tpu.transform.rigid import Rigid3 as JRigid3
from dliom_tpu_torch import map_builder as TMB
from dliom_tpu_torch.backend import pose_graph as TPG
from dliom_tpu_torch.backend.compression import decompress
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.interop import node_record_from_numpy
from dliom_tpu_torch.io import pbstream as TP
from dliom_tpu_torch.transform.rigid import Rigid3
from test_multi_trajectory import _grids
from test_pbstream import _sample_graph
from test_pose_graph import _cfg, _make_node
from test_torch_serialization import CPU, _pg_overrides, assert_same_records, carried_graph
import torch_threads  # noqa: F401  (one torch thread per test process)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "reference_map.pbstream")
TOL = 1e-6


def _port_cfg():
    return t_load_config("basic", _pg_overrides())


def _port_graph():
    cfg = _port_cfg()
    return TPG.PoseGraph(cfg.pose_graph, cfg.trajectory_builder, device=CPU)


def same_message(a: bytes, b: bytes, path="msg"):
    """Two protobuf messages agree field by field: varints, ids and packed
    arrays exact, doubles and floats within TOL (an absent double is 0.0,
    proto3's zero skip)."""
    if a == b:
        return
    ma, mb = TP.parse_message(a), TP.parse_message(b)
    for field in sorted(set(ma) | set(mb)):
        va, vb = ma.get(field, []), mb.get(field, [])
        wts = {wt for wt, _ in va + vb}
        if wts == {1}:
            xa = [struct.unpack("<d", v)[0] for _, v in va] or [0.0]
            xb = [struct.unpack("<d", v)[0] for _, v in vb] or [0.0]
            np.testing.assert_allclose(xb, xa, atol=TOL, err_msg=f"{path}.{field}")
            continue
        assert len(va) == len(vb), f"{path}.{field}: {len(va)} vs {len(vb)} values"
        for k, ((wa, x), (wb, y)) in enumerate(zip(va, vb)):
            assert wa == wb, f"{path}.{field}[{k}] wire type"
            if wa == 5:
                np.testing.assert_allclose(struct.unpack("<f", y), struct.unpack("<f", x), atol=TOL,
                                           err_msg=f"{path}.{field}[{k}]")
            elif wa == 2 and x != y:
                same_message(x, y, f"{path}.{field}[{k}]")
            else:
                assert x == y, f"{path}.{field}[{k}]: {x!r} vs {y!r}"


def _graph_with_streams():
    """tests/test_pbstream.py's sample graph with its sensor streams."""
    cfg, jpg, points = _sample_graph()
    jpg.add_fixed_frame_pose(0, [0.1, 0.2, 0.3])
    jpg.add_fixed_frame_pose(1, [2.1, 0.7, 0.3])
    jpg.add_landmark_observation(1, "lm_7", [0.5, -0.2, 1.0], weight=123.0,
                                 rotation_in_tracking=np.asarray([0.0, 0.0, 0.0, 1.0]),
                                 rotation_weight=4.5)
    jpg.add_landmark_observation(1, "lm_off", [1.0, 0.0, 0.0], weight=0.0)
    jpg.odometry_links.append((0, 1, JRigid3.translation_only(jnp.asarray([2.0, 0.5, 0.0]))))
    return cfg, jpg


@pytest.mark.parametrize("writer", ["map", "range_data"])
def test_writers_match_field_by_field(tmp_path, writer):
    _, jpg = _graph_with_streams()
    tpg = carried_graph(jpg)
    jw, tw = ((JP.write_pbstream, TP.write_pbstream) if writer == "map"
              else (JP.write_range_data_pbstream, TP.write_range_data_pbstream))
    j_path, t_path = str(tmp_path / "jax.pbstream"), str(tmp_path / "port.pbstream")
    jw(j_path, jpg)
    tw(t_path, tpg)
    want, got = list(JP.PbstreamReader(j_path)), list(TP.PbstreamReader(t_path))
    assert len(got) == len(want) == (3 + 2 + 2 + 1 + 2 + 2 + 2 if writer == "map" else 3)
    for k, (a, b) in enumerate(zip(want, got)):
        same_message(a, b, f"message {k}")


def test_range_data_stream(tmp_path):
    """-save_range_data: a header and one NodeRangeData per node, returns in
    the local frame (tests/test_pbstream.py::test_range_data_pbstream_schema's
    checks, read back with the port's parser)."""
    _, jpg = _graph_with_streams()
    tpg = carried_graph(jpg)
    path = str(tmp_path / "range.pbstream")
    TP.write_range_data_pbstream(path, tpg)
    blobs = list(TP.PbstreamReader(path))
    assert len(blobs) == 1 + len(tpg.nodes)
    assert TP._varint_field(TP.parse_message(blobs[0]), 1) == TP.FORMAT_VERSION
    n1 = TP.parse_message(blobs[2])
    assert TP._varint_field(n1, 3) == 1
    assert abs(TP.from_universal_ticks(TP._varint_field(n1, 1)) - 12.25) < 1e-6
    pose = TP._parse_rigid3d(TP._first(n1, 4))
    np.testing.assert_allclose(pose.translation[:2], [2.0, 0.5], atol=1e-6)
    returns = TP.parse_message(TP._first(n1, 5)).get(2, [])
    node = tpg.nodes[1]
    assert len(returns) == int(node.high_mask.sum())
    r0 = TP.parse_message(returns[0][1])
    want = node.high_points[node.high_mask][0] + np.asarray([2.0, 0.5, 0.0])
    np.testing.assert_allclose([TP._float(r0, k) for k in (1, 2, 3)], want, atol=1e-5)


def test_load_reference_fixture_equal_records():
    cfg = _cfg()
    jpg = JPoseGraph(cfg.pose_graph, cfg.trajectory_builder)
    j_map = JP.load_pbstream_into(jpg, FIXTURE, frozen=True)
    tpg = _port_graph()
    t_map = TP.load_pbstream_into(tpg, FIXTURE, frozen=True)
    assert t_map == j_map
    assert_same_records(jpg, tpg)
    assert tpg.trajectory_states() == jpg.trajectory_states()
    assert all(s.frozen for s in tpg.submaps) and all(n.frozen for n in tpg.nodes)
    assert tpg.submaps[0].high.indices.device == CPU
    assert isinstance(tpg.nodes[0].high_points, np.ndarray)


def test_localizes_against_reference_fixture():
    """tests/test_pbstream.py::test_localizes_against_reference_schema_fixture
    on the port (CPU): the fixture loads frozen through map_builder_from_state,
    a live revisit from the wrong start (3, -2, 0) finds an INTER
    constraint, and after the final optimization the live node sits within
    0.4 m of the fixture map's origin."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from tools.make_reference_fixture import fixture_world_cloud

    cfg = _port_cfg()
    builder = TMB.map_builder_from_state(FIXTURE, cfg, pure_localization=True, device=CPU)
    pg = builder.pose_graph
    frozen_tid = pg.submaps[0].trajectory_id
    assert pg.submaps[0].frozen and pg.submaps[0].finished
    assert pg.trajectory_states()[frozen_tid] == "FROZEN"
    assert int(pg.submaps[0].high.count) > 0

    world = fixture_world_cloud()
    wrong = np.asarray([3.0, -2.0, 0.0])
    s1 = pg.add_submap(Rigid3(np.asarray([1.0, 0, 0, 0]), wrong), trajectory_id=0)
    node = node_record_from_numpy(_make_node(_cfg(), world, JRigid3.translation_only(jnp.asarray(wrong))))
    node.trajectory_id = 0
    g_hi, g_lo = (torch.from_numpy(np.array(g)) for g in _grids(_cfg(), world))
    pg.add_node(node, (s1,), newly_finished_submap_id=s1, finished_grids=(g_hi, g_lo))
    assert [c for c in pg.constraints if c.tag == "INTER"], "no localization constraint"
    assert pg.trajectories_connected(frozen_tid, 0)
    pg.run_final_optimization()
    err = float(np.linalg.norm(pg.nodes[-1].global_pose.translation))
    assert err < 0.4, err
    np.testing.assert_allclose(pg.submaps[0].global_pose.translation, 0.0, atol=1e-6)


def test_port_roundtrip_with_sensor_streams(tmp_path):
    """The port's writer read back by the port's reader: poses within 1e-5,
    the finished grids decompress identically, INTRA bookkeeping rebuilt,
    fixed-frame / landmark observations re-attached to the nearest node,
    the odometry link rebuilt (tests/test_pbstream.py's round-trip checks)."""
    _, jpg = _graph_with_streams()
    tpg = carried_graph(jpg)
    path = str(tmp_path / "out.pbstream")
    TP.write_pbstream(path, tpg)
    kinds = [next(iter(TP.parse_message(b))) for b in TP.PbstreamReader(path)]
    assert (kinds.count(7), kinds.count(8), kinds.count(9)) == (2, 2, 2)
    pg2 = _port_graph()
    assert len(TP.load_pbstream_into(pg2, path, frozen=True)) == 1
    assert (len(pg2.submaps), len(pg2.nodes), len(pg2.constraints)) == \
           (len(tpg.submaps), len(tpg.nodes), len(tpg.constraints))
    assert all(s.frozen for s in pg2.submaps)
    for a, b in zip(tpg.submaps, pg2.submaps):
        np.testing.assert_allclose(b.global_pose.translation, a.global_pose.translation, atol=1e-5)
    hi = tpg._hi_spec
    assert torch.equal(decompress(pg2.submaps[0].high, hi), decompress(tpg.submaps[0].high, hi))
    assert pg2.submaps[0].node_ids and pg2.nodes[0].submap_ids
    nid, pos, _ = pg2.fixed_frame_observations[1]
    assert nid == 1
    np.testing.assert_allclose(pos, [2.1, 0.7, 0.3], atol=1e-9)
    (n0, n1, _, _, rq, lpos, w_t, w_r) = pg2.landmark_observations[0]
    assert n1 == 1 and "lm_7" in pg2._landmark_ids and (w_t, w_r) == (123.0, 4.5)
    np.testing.assert_allclose(rq, [0.0, 0.0, 0.0, 1.0], atol=1e-9)
    assert pg2.landmark_observations[1][6] == 0.0
    (a, b, rel), = pg2.odometry_links
    assert (a, b) == (0, 1)
    np.testing.assert_allclose(rel.translation, [2.0, 0.5, 0.0], atol=1e-5)
    pg2.run_optimization(iterations=2)


def test_map_builder_from_pbstream_is_frozen(tmp_path):
    _, jpg, _ = _sample_graph()
    path = str(tmp_path / "map.pbstream")
    TP.write_pbstream(path, carried_graph(jpg))
    builder = TMB.map_builder_from_state(path, _port_cfg(), pure_localization=True, device=CPU)
    states = builder.pose_graph.trajectory_states()
    assert len(builder.pose_graph.submaps) == len(jpg.submaps)
    assert all(s.frozen for s in builder.pose_graph.submaps)
    assert states[0] == "ACTIVE" and "FROZEN" in states.values()
    assert builder._pure_localization


def test_time_conversion_matches_jax():
    for t in (0.0, 12.25, 1723908000.1234567):
        assert TP.to_universal_ticks(t) == JP.to_universal_ticks(t)
        assert TP.from_universal_ticks(TP.to_universal_ticks(t)) == \
            JP.from_universal_ticks(JP.to_universal_ticks(t))

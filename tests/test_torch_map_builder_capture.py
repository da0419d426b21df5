"""The capture rule of `MapBuilder` (dliom_tpu_torch/map_builder.py): the
banks are updated in place, so a finished submap's grids are captured
(compressed into new tensors) before the next step recycles their slot. At
`pipeline_depth=1` the port must equal its run at depth 0 bit for bit
(captured grids, node data, poses), and each captured grid must equal, bit
for bit, what the JAX package's capture (`compress` of the slot, or
`compress_brick`) computes from the same bank state — on a dense, a mixed
(brick high, dense low) and a two-brick config. The stream and config are
tests/test_torch_map_builder.py's.

The `flagship` case runs bench.py's flagship submaps (`bench_e2e(flagship=
True)`: 0.1 m / 60 m high and 0.45 m low bricks, 512 / 192 apply groups,
448^3 / 288^3 backend crops) with one cut: num_range_data 16 -> 2, so that
a submap finishes within the 8-scan stream. Its captures are held against
JAX's `compress_brick` into the 448^3 / 288^3 crops, and the first
HELD_INSERTS brick inserts of the depth-0 run (one of which drops groups:
both active submaps take that scan) against JAX's `_insert_brick_slots`
from the same bank and inputs, bit for bit, the drop gauges included (the
course's drops on the card are chip_smoke.py's phase 15). Decompressing a 448^3 crop and
building its pyramid is left to phase 15, which holds those programs
against their eager bodies on the card: at this size they are the full
configuration, which the shared CPU here does not run (the case turns off
the submap image, whose projection would decompress one)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dliom_tpu.backend import compression as JC
from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.mapping import brick_grid as JB
from dliom_tpu.mapping import submap as JS
from dliom_tpu_torch import map_builder as TMB
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.mapping import submap as TS
from dliom_tpu_torch.interop import to_numpy
from test_torch_map_builder import _feed, _overrides, _stream
import torch_threads  # noqa: F401  (one torch thread per test process)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench_torch import flagship_submaps  # noqa: E402  (held equal to bench.py's, tests/test_torch_bench.py)


_compress_brick = jax.jit(JB.compress_brick, static_argnums=(1, 2, 3, 4))


def _jax_capture(tb_cfg, submaps_np, slot, pg):
    """What the JAX package captures from this bank state (its jitted
    `compress_brick`, as map_builder.py:637 / :651 jit it)."""
    sm = tb_cfg.submaps
    hi, lo = JS.grid_specs(sm)
    out = []
    for brick, values, bank, bspec, spec, cap in (
            (sm.use_brick_grid, submaps_np.high_values, submaps_np.high_brick, JS.brick_spec(sm), hi,
             pg._compress_capacity),
            (sm.use_brick_grid_low, submaps_np.low_values, submaps_np.low_brick,
             JS.brick_spec_low(sm), lo, pg.low_compress_capacity)):
        if brick:
            c = _compress_brick(JB.BrickBank(*(jnp.asarray(x) for x in bank)), bspec, slot, spec, cap)
        else:
            c = JC.compress(jnp.asarray(values[slot * spec.num_cells:(slot + 1) * spec.num_cells]),
                            spec, cap)
        out.append(jax.tree.map(np.asarray, c))
    return out


BRICK = {"high_resolution": 0.1, "high_resolution_max_range": 30.0, "use_brick_grid": True,
         "brick_dir_extent": 32, "brick_max_bricks": 4096, "brick_apply_groups": 512,
         "high_resolution_extent": 224}
BRICK_LOW = {"low_resolution": 0.45, "use_brick_grid_low": True, "low_brick_dir_extent": 12,
             "low_brick_max_bricks": 1024, "low_brick_apply_groups": 128,
             "low_brick_apply_group_bricks": 8, "low_resolution_extent": 56}


FLAGSHIP = dict(flagship_submaps(), num_range_data=2)  # bench.py ships 16
HELD_INSERTS = 6  # brick inserts held against JAX: 2 scans into one slot, 1 into both (drops)


def _recording_inserts(monkeypatch, inserts):
    """Hold the first HELD_INSERTS brick inserts of the port's frontend
    against JAX's `_insert_brick_slots` from the same bank and inputs (the
    depth-0 run's: `inserts` is switched on by the caller); appends the
    fields that differ, both drop gauges and the records per call."""
    real = TS._insert_brick_slots
    jitted = jax.jit(JB._insert_brick_slots, donate_argnums=0, static_argnames=(
        "spec", "hit_probability", "miss_probability", "num_free_space_voxels"))

    def recording(bank, origins, hits, masks, *, spec, **kw):
        if not inserts["on"] or len(inserts["calls"]) >= HELD_INSERTS:
            return real(bank, origins, hits, masks, spec=spec, **kw)
        jbank = JB.BrickBank(*(jnp.asarray(x.numpy().copy()) for x in bank))  # the port updates in place
        args = [jnp.asarray(x.numpy().copy()) for x in (origins, hits, masks)]
        out = real(bank, origins, hits, masks, spec=spec, **kw)
        want = jitted(jbank, *args, spec=JB.BrickGridSpec(*spec), **kw)
        inserts["calls"].append(([f for f in JB.BrickBank._fields
                                  if not np.array_equal(getattr(out, f).numpy(), np.asarray(getattr(want, f)))],
                                 int(out.dropped[0]), int(np.asarray(want.dropped)[0]), int(masks.sum())))
        return out

    monkeypatch.setattr(TS, "_insert_brick_slots", recording)


@pytest.mark.parametrize("grids", ["dense", "mixed", "brick", "flagship"])
def test_pipelined_capture_bit_identical(grids, monkeypatch):
    submaps = {"dense": {}, "mixed": BRICK, "brick": dict(BRICK, **BRICK_LOW), "flagship": FLAGSHIP}[grids]
    over = _overrides(submaps=submaps)
    if grids == "flagship":
        # no submap image: it would decompress a 448^3 crop (phase 15's)
        over["pose_graph"]["constraint_builder"] = {"use_image_proposals": False}
    jcfg = j_load_config("basic", over).trajectory_builder
    captured = {0: [], 1: []}
    real = TMB._TrajectoryBuilder._capture_grids

    def recording(self, host):
        out = real(self, host)
        if out is not None:
            slot = int(host["finished_submap"]) % 2
            state = to_numpy(self._lio.frontend.submaps)
            depth = self.parent._pipeline_depth
            # the flagship's depth-1 captures are held to depth 0's below
            want = (_jax_capture(jcfg, state, slot, self.parent.pose_graph)
                    if grids != "flagship" or depth == 0 else None)
            captured[depth].append((to_numpy(out), want))
        return out

    monkeypatch.setattr(TMB._TrajectoryBuilder, "_capture_grids", recording)
    inserts = {"on": False, "calls": []}
    if grids == "flagship":
        _recording_inserts(monkeypatch, inserts)
    events = _stream(9 if grids == "dense" else 8)
    builders = {}
    for depth in (0, 1):
        inserts["on"] = grids == "flagship" and depth == 0
        b = TMB.MapBuilder(t_load_config("basic", over), pipeline_depth=depth,
                           device=torch.device("cpu"))
        _feed(b, events, 1)
        builders[depth] = b
    assert len(captured[0]) == len(captured[1]) >= 1
    for depth in (0, 1):
        for port, jax_capture in captured[depth]:
            for a, b in zip(jax_capture or (), port):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(y, x)
    for (p0, _), (p1, _) in zip(captured[0], captured[1]):
        for a, b in zip(p0, p1):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
    n0, n1 = builders[0].pose_graph.nodes, builders[1].pose_graph.nodes
    assert len(n0) == len(n1) > 0
    for a, b in zip(n0, n1):
        np.testing.assert_array_equal(b.local_pose.translation, a.local_pose.translation)
        np.testing.assert_array_equal(b.high_points, a.high_points)
    finished = [s for s in builders[1].pose_graph.submaps if s.finished]
    assert finished and all(int(s.high.count) > 0 for s in finished)
    if grids == "flagship":
        specs = [sp.num_cells for sp in TS.grid_specs(t_load_config("basic", over).trajectory_builder.submaps)]
        assert specs == [448 ** 3, 288 ** 3]
        calls = inserts["calls"]
        assert len(calls) == HELD_INSERTS and any(c[3] for c in calls)
        assert any(c[1] for c in calls), "the held inserts drop groups (two slots at 512 / 192)"
        assert all(not differ and got == want for differ, got, want, _ in calls), calls

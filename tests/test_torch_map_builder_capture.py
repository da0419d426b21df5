"""The capture rule of `MapBuilder` (dliom_tpu_torch/map_builder.py): the
banks are updated in place, so a finished submap's grids are captured
(compressed into new tensors) before the next step recycles their slot. At
`pipeline_depth=1` the port must equal its run at depth 0 bit for bit
(captured grids, node data, poses), and each captured grid must equal, bit
for bit, what the JAX package's capture (`compress` of the slot, or
`compress_brick`) computes from the same bank state — on a dense, a mixed
(brick high, dense low) and a two-brick config. The stream and config are
tests/test_torch_map_builder.py's."""

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
from dliom_tpu_torch.interop import to_numpy
from test_torch_map_builder import _feed, _overrides, _stream
import torch_threads  # noqa: F401  (one torch thread per test process)


def _jax_capture(tb_cfg, submaps_np, slot, pg):
    """What the JAX package captures from this bank state."""
    sm = tb_cfg.submaps
    hi, lo = JS.grid_specs(sm)
    out = []
    for brick, values, bank, bspec, spec, cap in (
            (sm.use_brick_grid, submaps_np.high_values, submaps_np.high_brick, JS.brick_spec(sm), hi,
             pg._compress_capacity),
            (sm.use_brick_grid_low, submaps_np.low_values, submaps_np.low_brick,
             JS.brick_spec_low(sm), lo, pg.low_compress_capacity)):
        if brick:
            c = JB.compress_brick(JB.BrickBank(*(jnp.asarray(x) for x in bank)), bspec, slot, spec, cap)
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


@pytest.mark.parametrize("grids", ["dense", "mixed", "brick"])
def test_pipelined_capture_bit_identical(grids, monkeypatch):
    submaps = {"dense": {}, "mixed": BRICK, "brick": dict(BRICK, **BRICK_LOW)}[grids]
    over = _overrides(submaps=submaps)
    jcfg = j_load_config("basic", over).trajectory_builder
    captured = {0: [], 1: []}
    real = TMB._TrajectoryBuilder._capture_grids

    def recording(self, host):
        out = real(self, host)
        if out is not None:
            slot = int(host["finished_submap"]) % 2
            state = to_numpy(self._lio.frontend.submaps)
            captured[self.parent._pipeline_depth].append(
                (to_numpy(out), _jax_capture(jcfg, state, slot, self.parent.pose_graph)))
        return out

    monkeypatch.setattr(TMB._TrajectoryBuilder, "_capture_grids", recording)
    events = _stream(9 if grids == "dense" else 8)
    builders = {}
    for depth in (0, 1):
        b = TMB.MapBuilder(t_load_config("basic", over), pipeline_depth=depth,
                           device=torch.device("cpu"))
        _feed(b, events, 1)
        builders[depth] = b
    assert len(captured[0]) == len(captured[1]) >= 1
    for depth in (0, 1):
        for port, jax_capture in captured[depth]:
            for a, b in zip(jax_capture, port):
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

"""The port's `MapBuilder` on the shipped presets' new paths against the
JAX package, at reduced extents (tests/preset_streams.py): `campus`, which
initializes in motion (NDT dynamic initialization), and `viral`, whose
high grid takes the per-record brick insert (`brick_apply_groups` 0).
Held as tests/test_torch_map_builder.py holds them: the same nodes and
submaps, local poses within 2e-3 (m, and quaternion components)."""

import pytest
import torch

from dliom_tpu.common.config import load_config as j_load_config
from dliom_tpu.map_builder import MapBuilder as JMapBuilder
from dliom_tpu_torch.common.config import load_config as t_load_config
from dliom_tpu_torch.map_builder import MapBuilder as TMapBuilder
from tests.preset_streams import REDUCE, feed, stream
from tests.test_torch_map_builder import _compare_graphs
import torch_threads  # noqa: F401  (one torch thread per test process)


@pytest.mark.parametrize("preset,scans", [("campus", 14), ("viral", 14)])
def test_preset_map_builder_matches_jax(preset, scans):
    jcfg, tcfg = j_load_config(preset, REDUCE), t_load_config(preset, REDUCE)
    tb = tcfg.trajectory_builder
    assert tb.enable_ndt_initialization == (preset == "campus")
    assert (tb.submaps.use_brick_grid and tb.submaps.brick_apply_groups == 0) == (preset == "viral")
    events = stream(scans, tb)
    jb = JMapBuilder(jcfg)
    tmb = TMapBuilder(tcfg, pipeline_depth=1, device=torch.device("cpu"))
    feed(jb, events)
    feed(tmb, events)
    _compare_graphs(jb, tmb)
    assert len(tmb.local_trajectory(0)) >= 6

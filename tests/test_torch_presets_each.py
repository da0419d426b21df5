"""Every shipped preset runs on the port: for each entry of `PRESETS` a
CPU `MapBuilder` at reduced extents (tests/preset_streams.py) initializes,
statically or in motion as the preset ships, and steps at least 6 scans
with finite local poses and no dropped grid updates. No preset raises
NotImplementedError."""

import numpy as np
import pytest
import torch

from dliom_tpu_torch.common.config import PRESETS, load_config
from dliom_tpu_torch.map_builder import MapBuilder
from tests.preset_streams import REDUCE, feed, stream
import torch_threads  # noqa: F401  (one torch thread per test process)

STEPS = 6


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_builds_and_steps(preset):
    cfg = load_config(preset, REDUCE)
    tb = cfg.trajectory_builder
    init_scans = (tb.frames_for_dynamic_initialization + 1 if tb.enable_ndt_initialization
                  else tb.frames_for_static_initialization + 1)
    builder = MapBuilder(cfg, device=torch.device("cpu"))
    feed(builder, stream(init_scans + STEPS, tb))
    assert builder.initialized
    results = builder.local_trajectory(0)
    assert len(results) >= STEPS
    for r in results:
        assert np.isfinite(r["local_pose"].translation).all() and np.isfinite(r["local_pose"].rotation).all()
    submaps = builder.trajectory(0)._lio.frontend.submaps
    drops = [int(b.dropped[0]) for b in (submaps.high_brick, submaps.low_brick) if b is not None]
    assert sum(drops) + int(submaps.dense_dropped[0]) == 0

"""What the systems under test share (benchmark/systems/<name>.py): the
port's LIO step over `lanes` sequences, built from the configuration's
preset and overrides. The benchmark takes from the port only its entries,
its configuration code and its kernel build; it makes the inputs itself
(benchmark/generator.py).

A system has the interface that a loop (benchmark/loops/<name>.py)
drives: `start(starts)`, `step(inp)`, `packed()` (pose, velocity and
biases of every lane, (L, PACKED) on the device), `snapshot(lanes)` (a
copy of the state on the device, or of those lanes), `lane(snap, b)`
(lane b of a snapshot as a single sequence's state, which
`benchmark.reference.step.convert` takes), `restore(snap)` (of a whole
snapshot), `drops()`, `counts()` and `free()`.
"""

from __future__ import annotations

import copy

import torch
from torch.utils._pytree import tree_map

from benchmark.reference import lanes as ref_lanes
from benchmark.reference import step as ref

CAPACITY_KEYS = ("brick_apply_groups", "low_brick_apply_groups", "dense_apply_groups")


def lane_overrides(overrides: dict, lanes: int) -> dict:
    """The configuration's overrides with K1's per-call capacities times
    the lanes, since one batched call holds every lane's touched groups."""
    out = copy.deepcopy(overrides)
    if lanes > 1:
        sub = out.setdefault("trajectory_builder", {}).setdefault("submaps", {})
        for k in CAPACITY_KEYS:
            if k in sub:
                sub[k] = sub[k] * lanes
    return out


class LioProgram:
    """The port's LIO step over `lanes` sequences; a system file's `System`
    supplies `start`, which builds the entry it drives."""

    def __init__(self, spec: dict, lanes: int, device: torch.device):
        from dliom_tpu_torch import kernels
        from dliom_tpu_torch.common.config import load_config
        from dliom_tpu_torch.frontend.lio import LioScanInput

        if device.type == "cuda":
            kernels.build()
        self.spec = spec
        self.lanes = lanes
        self.device = device
        self.cfg = load_config(spec["preset"], lane_overrides(spec.get("overrides") or {}, lanes)).trajectory_builder
        self.specs = ref.spec_numbers(ref.config(spec))
        self.state = self.result = self.graph = None
        self.input_type = LioScanInput

    def one_state(self, start):
        """A single sequence's state at `start`: (rotation, position,
        velocity, ba, bg)."""
        from dliom_tpu_torch.frontend.lio import make_lio_state
        from dliom_tpu_torch.imu import preintegration as pre

        rot, pos, vel, ba, bg = (torch.as_tensor(x, dtype=torch.float32, device=self.device) for x in start)
        return make_lio_state(self.cfg, pre.NavState(rot, pos, vel), ba, bg)

    def start(self, starts) -> None:
        raise NotImplementedError

    def step(self, inp) -> None:
        self.state, self.result = self.graph(self.state, inp)

    def packed(self) -> torch.Tensor:
        return ref.pack(self.result).reshape(self.lanes, ref.PACKED)

    def snapshot(self, lanes=None):
        """A copy of the state (of the given lanes only, where a system can
        copy lanes apart)."""
        return tree_map(lambda x: None if x is None else x.clone(), self.state)

    def lane(self, snap, b: int):
        return snap

    def restore(self, snap) -> None:
        """Make a snapshot the state the next step starts from."""
        self.graph.load_state(snap)
        self.state = self.graph.state

    def drops(self) -> dict:
        return ref_lanes.drops(self.state)

    def counts(self) -> dict:
        return self.graph.counts()

    def free(self) -> None:
        self.graph = self.state = self.result = None

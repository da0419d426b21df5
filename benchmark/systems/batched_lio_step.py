"""B sequences in lockstep through the port's batched compiled LIO step,
`parallel/batch.py::make_batched_lio_step`: every per-sequence leaf carries
a leading lane axis, the grid banks are shared (lane b in slots 2b, 2b + 1)."""

from torch.utils._pytree import tree_flatten_with_path

from benchmark.program import LioProgram
from benchmark.reference import lanes as ref_lanes


def _path_names(path) -> tuple:
    return tuple(getattr(k, "name", getattr(k, "key", getattr(k, "idx", None))) for k in path)


class System(LioProgram):
    def start(self, starts) -> None:
        """Each lane's state at its start, written into the batched state."""
        from dliom_tpu_torch.parallel.batch import make_batched_lio_state, make_batched_lio_step

        state = make_batched_lio_state(self.cfg, self.lanes, self.device)
        leaves, _ = tree_flatten_with_path(state)
        for b, start in enumerate(starts):
            one = {_path_names(p): x for p, x in tree_flatten_with_path(self.one_state(start))[0]}
            for path, x in leaves:
                names = _path_names(path)
                y = one.get(names)
                # per-lane leaves carry a leading lane axis; the shared banks,
                # drop gauges and lane ids keep their own layout
                if y is not None and names[-1] != "lane" and x.shape == (self.lanes,) + y.shape:
                    x[b].copy_(y)
        self.state = state
        self.graph = make_batched_lio_step(self.cfg, self.lanes)

    def snapshot(self, lanes=None):
        """The whole batched state (of all lanes), or copies of some lanes
        as single sequences' states (lane b's two slots of the shared banks)."""
        if lanes is None or len(lanes) == self.lanes:
            return super().snapshot()
        return {b: ref_lanes.lane_state(self.state, b, self.specs) for b in lanes}

    def lane(self, snap, b: int):
        return snap[b] if isinstance(snap, dict) else ref_lanes.lane_state(snap, b, self.specs)

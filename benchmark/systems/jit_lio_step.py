"""One sequence through the port's compiled LIO step,
`frontend/lio.py::make_jit_lio_step` (a CUDA graph replayed each step)."""

from benchmark.program import LioProgram


class System(LioProgram):
    def start(self, starts) -> None:
        """The state at the only lane's start."""
        from dliom_tpu_torch.frontend.lio import make_jit_lio_step

        if self.lanes != 1 or len(starts) != 1:
            raise ValueError(f"make_jit_lio_step runs one sequence, not {self.lanes}")
        self.state = self.one_state(starts[0])
        self.graph = make_jit_lio_step(self.cfg)

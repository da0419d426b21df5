"""stage.rest_ms (ms/step): device time a compiled step between its stage
marks (for `rest`, the step's time less the stages'), median over the
replays, of `rest`: the step outside its marked stages: the spawn, the
match target, the gravity, finish_step and the write-back."""

from benchmark.metrics import marks

SOURCE = "program_span"


def read(ctx):
    return marks.stage(ctx, "rest", "ms")

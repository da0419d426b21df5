"""stage.window_ms (ms/step): device time a compiled step between its stage
marks (for `rest`, the step's time less the stages'), median over the
replays, of `lio.window`: the sliding-window Gauss-Newton and the failure
reset."""

from benchmark.metrics import marks

SOURCE = "program_span"


def read(ctx):
    return marks.stage(ctx, "window", "ms")

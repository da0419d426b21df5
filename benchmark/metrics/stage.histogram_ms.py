"""stage.histogram_ms (ms/step): device time a compiled step between its
stage marks (for `rest`, the step's time less the stages'), median over
the replays, of `frontend.histogram`: the rotational histogram."""

from benchmark.metrics import marks

SOURCE = "program_span"


def read(ctx):
    return marks.stage(ctx, "histogram", "ms")

"""stage.filter_ms (ms/step): device time a compiled step between its stage
marks (for `rest`, the step's time less the stages'), median over the
replays, of `frontend.filter`: the prediction, deskew, range clip and
voxel and adaptive filters."""

from benchmark.metrics import marks

SOURCE = "program_span"


def read(ctx):
    return marks.stage(ctx, "filter", "ms")

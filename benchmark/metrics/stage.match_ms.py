"""stage.match_ms (ms/step): device time a compiled step between its stage
marks (for `rest`, the step's time less the stages'), median over the
replays, of `frontend.match`: the scan-to-submap LM match."""

from benchmark.metrics import marks

SOURCE = "program_span"


def read(ctx):
    return marks.stage(ctx, "match", "ms")

"""stage.insert_ms (ms/step): device time a compiled step between its stage
marks (for `rest`, the step's time less the stages'), median over the
replays, of `frontend.insert`: the motion filter and the grid inserts
(K1), in the batched step the flat insert of every lane too."""

from benchmark.metrics import marks

SOURCE = "program_span"


def read(ctx):
    return marks.stage(ctx, "insert", "ms")

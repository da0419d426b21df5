"""step.device_ms_per_step (ms/step): device time of a compiled step, its
first stage mark to its last (the mark before the body to the one after
the write-back), median over the replays."""

from benchmark.metrics import marks

SOURCE = "program_span"


def read(ctx):
    return marks.value(ctx, "device_ms")

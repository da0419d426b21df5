"""stage.window_kernels (kernels/step): kernels a compiled step launches,
counted at the graph's capture between its stage marks (the marks left
out), of `lio.window`: the sliding-window Gauss-Newton and the failure
reset."""

from benchmark.metrics import marks

SOURCE = "program_counter"


def read(ctx):
    return marks.stage(ctx, "window", "kernels")

"""stage.histogram_kernels (kernels/step): kernels a compiled step launches,
counted at the graph's capture between its stage marks (the marks left
out), of `frontend.histogram`: the rotational histogram."""

from benchmark.metrics import marks

SOURCE = "program_counter"


def read(ctx):
    return marks.stage(ctx, "histogram", "kernels")

"""stage.match_kernels (kernels/step): kernels a compiled step launches,
counted at the graph's capture between its stage marks (the marks left
out), of `frontend.match`: the scan-to-submap LM match."""

from benchmark.metrics import marks

SOURCE = "program_counter"


def read(ctx):
    return marks.stage(ctx, "match", "kernels")

"""stage.filter_kernels (kernels/step): kernels a compiled step launches,
counted at the graph's capture between its stage marks (the marks left
out), of `frontend.filter`: the prediction, deskew, range clip and voxel
and adaptive filters."""

from benchmark.metrics import marks

SOURCE = "program_counter"


def read(ctx):
    return marks.stage(ctx, "filter", "kernels")

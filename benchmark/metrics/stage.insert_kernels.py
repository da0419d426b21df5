"""stage.insert_kernels (kernels/step): kernels a compiled step launches,
counted at the graph's capture between its stage marks (the marks left
out), of `frontend.insert`: the motion filter and the grid inserts (K1),
in the batched step the flat insert of every lane too."""

from benchmark.metrics import marks

SOURCE = "program_counter"


def read(ctx):
    return marks.stage(ctx, "insert", "kernels")

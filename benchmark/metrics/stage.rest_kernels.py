"""stage.rest_kernels (kernels/step): kernels a compiled step launches,
counted at the graph's capture between its stage marks (the marks left
out), of `rest`: the step outside its marked stages: the spawn, the match
target, the gravity, finish_step and the write-back."""

from benchmark.metrics import marks

SOURCE = "program_counter"


def read(ctx):
    return marks.stage(ctx, "rest", "kernels")

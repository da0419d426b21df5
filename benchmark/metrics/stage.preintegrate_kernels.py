"""stage.preintegrate_kernels (kernels/step): kernels a compiled step
launches, counted at the graph's capture between its stage marks (the
marks left out), of `lio.preintegrate`: the IMU bridge: preintegration
(K2) and the prediction."""

from benchmark.metrics import marks

SOURCE = "program_counter"


def read(ctx):
    return marks.stage(ctx, "preintegrate", "kernels")

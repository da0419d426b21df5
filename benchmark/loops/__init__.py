"""Loops: one file a way of driving a system, benchmark/loops/<name>.py,
named by a traffic mix's `loop`. Each has `run(cell, seed, seconds,
trace, t_start, device, make)`, which does the set-up, the window and the
check, and returns the end-to-end values, the context that per-layer
metrics read (benchmark/metrics/), the numbers compared, and the run's
counts. A mix that needs another loop (open loop, a served path) adds a
file here and names it."""

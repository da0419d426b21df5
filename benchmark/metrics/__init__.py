"""Per-layer metrics: one reader a file, benchmark/metrics/<metric>.py, named
as BENCHMARK.json names the metric. Each declares its SOURCE and has
`read(ctx)`, which returns the metric's value or None where the run gives
it nothing to read. `ctx` is what the cell's loop (benchmark/loops/)
filled: the closed loop's holds `trace` (benchmark/trace.py::reduce of the
traced stretch), `roofline_trace`, `k1_bytes`, `lanes`,
`imu_samples` and `counts`; a loop of another entry adds its own keys
(such as the program's counters) for the metrics that read them.
`roofline.py` holds the arithmetic of the rooflines."""

"""One intra-op torch thread per test process; every CPU test file of the
port (tests/test_torch_*.py) imports this.

Tier-1 runs the suite under pytest-xdist, several workers on the machine's
cores. Left at its default, torch gives each worker one OpenMP thread per
core, so the workers' threads oversubscribe the cores and wait on each
other: tests/test_torch_pbstream.py::test_localizes_against_reference_fixture
took 8.4 s alone on an 8-core host, 122.8 s beside six busy processes
there, and 11.0 s beside them with one thread.
"""

import torch

torch.set_num_threads(1)

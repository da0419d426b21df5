"""`correct`: the harness's comparison with the plain reference, at the small
size on the CPU (the port's CPU path against the frozen reference), with
the timed path broken underneath in each way a cell can break; and, on
the card, the control (the reference in TF32 in the program's place) at
the cells' own size."""

import time
from pathlib import Path

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.small import ROOT, small_root

REPLAY_CELLS = ("viral.replay", "campus.replay")
BATCH_CELL = "viral.batch18"
SMALL_LANES = 4


def _run(root: Path, cell: str, system: str, seed: int = 2**31 + 77):
    torch.set_num_threads(2)
    return harness.run(cell, seed, 0.5, False, time.perf_counter(), require_cuda=False, root=root,
                       system_factory=control.systems()[system])


@pytest.mark.parametrize("cell", REPLAY_CELLS + (BATCH_CELL,))
def test_the_port_agrees_with_the_reference(tmp_path, cell):
    r = _run(small_root(tmp_path, lanes=SMALL_LANES), cell, "program")
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in REPLAY_CELLS for f in ("unchanged", "altered", "skip_insert")]
                         + [(BATCH_CELL, f) for f in ("half", "skip_insert")])
def test_a_broken_step_is_not_correct(tmp_path, cell, fault):
    r = _run(small_root(tmp_path, lanes=SMALL_LANES), cell, fault)
    assert not r["correct"], r["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", REPLAY_CELLS + (BATCH_CELL,))
def test_the_control_in_tf32_is_not_correct(card, cell):
    """The reference in TF32 in the program's place at the checked steps,
    at the cell's own size on the card, on three seeds: each run reads not
    correct."""
    for seed in (101, 2**31 + 102, 103):
        r = harness.run(cell, seed, 1.0, False, time.perf_counter(), root=ROOT,
                        system_factory=control.systems()["control"])
        assert not r["correct"], (seed, r["checks"])

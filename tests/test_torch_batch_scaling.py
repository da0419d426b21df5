"""tools/torch_batch_scaling.py at its smallest size on the CPU: B = 1, 2
at the reduced config (`--small`); one JSON line per B with
tools/batch_scaling.py's keys (of the eager form, and again with `compiled_` for the
compiled chunk) plus `launches_per_step` and `peak_mem_mib`;
and the tool runs on the card unless told otherwise, so asking for CUDA
without one raises."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread per test process)

TOOL = Path(__file__).resolve().parents[1] / "tools" / "torch_batch_scaling.py"


def _tool():
    spec = importlib.util.spec_from_file_location("torch_batch_scaling", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_small_run_reports_each_batch(capsys):
    lines = _tool().main(["--bs", "1,2", "--device", "cpu", "--small"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert printed == lines and [x["batch"] for x in lines] == [1, 2]
    for x in lines:
        assert set(x) == {"batch", "aggregate_scans_per_sec", "per_seq_scans_per_sec", "scaling_vs_b1",
                          "compiled_aggregate_scans_per_sec", "compiled_per_seq_scans_per_sec",
                          "compiled_scaling_vs_b1", "launches_per_step", "peak_mem_mib"}
        assert x["aggregate_scans_per_sec"] > 0 and x["launches_per_step"] > 0
        assert x["compiled_aggregate_scans_per_sec"] > 0
        assert x["peak_mem_mib"] is None  # no device allocator on the CPU
    assert lines[0]["scaling_vs_b1"] == lines[0]["compiled_scaling_vs_b1"] == 1.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no card")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        _tool().main(["--bs", "1", "--small"])

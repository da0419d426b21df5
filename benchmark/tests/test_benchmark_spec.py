"""BENCHMARK.json against the rules its readers rely on, and the harness's
lookups: every cell, configuration, mix, limit and per-layer metric is
found by its name in files of its own."""

import json
import re
import subprocess
import sys
import textwrap

import pytest

from benchmark import harness
from benchmark.tests.small import ROOT, small_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"] and len(BENCH["command"]) <= 32
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    n = len(BENCH["workloads"])
    assert 2 + 14 * n and n <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
    assert entry["file"].startswith("benchmark/") and (ROOT / entry["file"]).is_file()
    spec = json.loads((ROOT / entry["file"]).read_text())
    assert spec["name"] == entry["name"] and sorted(spec["reduced"]) == sorted(entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    for text in (entry["source"], entry["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_is_found_by_name(work):
    assert set(work) == {"name", "config", "traffic", "chips", "why"} and work["chips"] == 1
    assert NAME.match(work["name"]) and NAME.match(work["traffic"]) and len(work["why"]) <= 200
    cell = harness.Cell(work["name"])
    assert cell.spec["name"] == work["config"]
    assert set(cell.limits) == {"state_gap", "imu_factor_gap", "map_mismatch_share", "dropped_groups"}
    assert cell.limits["dropped_groups"] == 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "scans_per_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    if metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == keys | {"bound"}
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) - {"workloads"} == keys | {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        reader = harness.metric_reader(ROOT / "benchmark" / "metrics", metric["name"])
        assert reader.SOURCE == metric["source"] and callable(reader.read)
        assert reader.read({"trace": {}, "roofline_trace": {}, "lanes": 1, "imu_samples": 40,
                            "k1_bytes": None}) is None
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_a_new_metric_needs_no_edit(tmp_path):
    root = small_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    bench["per_layer"].append({"name": "step.added", "unit": "count", "better": "lower", "source": "device_trace",
                               "layer": "compiled step", "moves": "scans_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "metrics" / "step.added.py").write_text(
        'SOURCE = "device_trace"\n\n\ndef read(ctx):\n    return 7.0\n')
    found = harness.Cell(cell, root)
    assert "step.added" in [m["name"] for m in found.per_layer]
    assert harness.metric_reader(found.metric_dir, "step.added").read({}) == 7.0


FIXED_LOOP = """
def run(cell, seed, seconds, trace, t_start, device, make):
    system = make(cell.spec, 1, device)
    return {"setup_s": 1.5, "values": {"scans_per_s": 2.0 * cell.traffic["rate"], "setup_s": 1.5},
            "ctx": {"trace": {}, "said": system.said}, "numbers": {"gap": 0.0}, "error": None,
            "attempted": 3, "failed": 0, "peak": 0, "info": {}}
"""


def test_a_new_mix_with_its_own_loop_and_system_needs_no_edit(tmp_path):
    """A mix that drives another entry in another loop is new files (its
    data, loop, system and limits) and a new cell in BENCHMARK.json."""
    root = small_root(tmp_path)
    base = root / "benchmark"
    (base / "loops" / "fixed_rate.py").write_text(FIXED_LOOP)
    (base / "systems" / "stub.py").write_text(
        "class System:\n    def __init__(self, spec, lanes, device):\n        self.said = spec['name']\n")
    (base / "traffic" / "fixed.json").write_text(json.dumps({"loop": "fixed_rate", "system": "stub", "rate": 4}))
    (base / "limits" / "viral.fixed.json").write_text(json.dumps({"gap": 0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "viral.fixed", "config": "viral", "traffic": "fixed", "chips": 1,
                               "why": "a stub"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run("viral.fixed", 5, 1.0, False, 0.0, require_cuda=False, root=root)
    assert r["correct"] is True and r["attempted"] == 3
    assert r["metrics"]["scans_per_s"]["value"] == 8.0 and r["checks"] == {"gap": {"value": 0.0, "limit": 0}}


def test_a_traced_run_counts_kernels_by_step(tmp_path):
    """A `--trace 1` run at the small size on the CPU: the traced stretch is
    reduced (steps, window, kernels by step), and the line holds per-layer
    metrics only."""
    import torch

    torch.set_num_threads(2)
    root = small_root(tmp_path)
    r = harness.run("viral.replay", 2**31 + 5, 0.3, True, 0.0, require_cuda=False, root=root)
    assert r["correct"] is True
    assert not set(r["metrics"]) & {m["name"] for m in BENCH["end_to_end"]}
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_forbidden_modules_are_compared_by_whole_top_level_names(monkeypatch):
    assert "dliom_tpu_torch" not in harness.FORBIDDEN
    monkeypatch.setitem(sys.modules, "dliom_tpu.fake", object())
    assert harness.forbidden_modules() == ["dliom_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole small run, in a process of its own: its modules, once the
    window has closed, hold no top-level name jax, jaxlib, flax or
    dliom_tpu, and the last line of its standard output is the result."""
    root = small_root(tmp_path)
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        torch.set_num_threads(2)
        from pathlib import Path
        from benchmark import harness
        r = harness.run("viral.replay", 31, 0.5, False, time.perf_counter(), require_cuda=False,
                        root=Path({str(root)!r}))
        print(json.dumps({{"held": harness.forbidden_modules(), "result": r}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["held"] == []
    r = line["result"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "gaps", "checks"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"scans_per_s", "scan_latency_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    last = out.stderr.strip().splitlines()[-len(r["checks"]):]
    assert [x.split()[1] for x in last] == list(r["checks"])


def test_no_result_without_a_card(tmp_path):
    """On a machine without CUDA the command prints no result and fails."""
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""

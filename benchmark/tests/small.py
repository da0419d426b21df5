"""A copy of the benchmark's tree with its cells cut to a size the CPU
runs in seconds: fewer rays, smaller grid pools, a short lap. The same
files, configurations and mixes otherwise, so a test drives the harness
as a run on the card does."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL_SENSOR = {"num_azimuths": 64, "num_bubbles": 40}
SMALL_SUBMAPS = {
    "viral": {"num_range_data": 4},
    "campus": {"high_resolution_extent": 64, "low_resolution_extent": 32, "num_range_data": 4},
}
SMALL_TRAFFIC = {"lap_scans": 24, "warmup_steps": 1, "check_strata": [[0, 2], [2, 4], [4, 6]], "check_run": 1,
                 "trace_steps": 2, "roofline_steps": [3]}


def small_root(tmp: Path, lanes: int = None, limits: dict = None) -> Path:
    """`tmp` made a checkout root holding BENCHMARK.json and benchmark/ at
    the small size; `lanes` overrides the batch mix's lanes, `limits`
    every cell's limits."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (tmp / "benchmark" / "configs").glob("*.json"):
        spec = json.loads(path.read_text())
        spec["sensor"].update(SMALL_SENSOR)
        sub = spec["overrides"].setdefault("trajectory_builder", {}).setdefault("submaps", {})
        sub.update(SMALL_SUBMAPS.get(spec["name"], {}))
        path.write_text(json.dumps(spec))
    for path in (tmp / "benchmark" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(SMALL_TRAFFIC)
        if lanes is not None and traffic["lanes"] > 1:
            traffic["lanes"] = lanes
        path.write_text(json.dumps(traffic))
    if limits is not None:
        for path in (tmp / "benchmark" / "limits").glob("*.json"):
            path.write_text(json.dumps(limits))
    return tmp

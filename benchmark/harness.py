"""One run of one cell: the generic part of `run.py`. Everything that
belongs to one configuration, traffic mix, loop, system or per-layer
metric is found by the name that BENCHMARK.json or the mix gives it:

  benchmark/configs/<config>.json    sizes, preset and overrides
  benchmark/traffic/<mix>.json       the mix's parameters, naming its
                                     `loop` and `system`
  benchmark/loops/<loop>.py          set-up, window and check
  benchmark/systems/<system>.py      the program entry driven
  benchmark/metrics/<metric>.py      a per-layer metric's reader
  benchmark/limits/<cell>.json       the cell's limits on its compared numbers

A new configuration, mix, loop, system or metric is a new file and new
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, List, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dliom_tpu")  # top-level module names, compared whole


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix, limits and metrics."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
        self.name = name
        self.workload = work[name]
        self.chips = self.workload["chips"]
        configs = {c["name"]: c for c in bench["configs"]}
        self.spec = json.loads((root / configs[self.workload["config"]]["file"]).read_text())
        self.base = root / "benchmark"
        self.traffic = json.loads((self.base / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads((self.base / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        self.metric_dir = self.base / "metrics"

    def module(self, kind: str, name: str):
        """benchmark/<kind>/<name>.py of this checkout."""
        return load_module(self.base / kind, name)


def load_module(directory: Path, name: str):
    """<directory>/<name>.py, loaded from its file (names hold dots)."""
    key = f"benchmark_{directory.name}_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(key, directory / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(metric_dir: Path, name: str):
    """benchmark/metrics/<name>.py."""
    return load_module(metric_dir, name)


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        system_factory: Optional[Callable] = None, require_cuda: bool = True, root: Path = ROOT) -> Optional[dict]:
    """One run; returns the result line's object (None where it must not
    print one). `system_factory(System)`, where given, turns the mix's
    system class into what is run in its place (benchmark/control.py)."""
    cell = Cell(cell_name, root)
    if require_cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        print(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return None
    device = torch.device("cuda:0" if require_cuda else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    make = cell.module("systems", cell.traffic["system"]).System
    if system_factory is not None:
        make = system_factory(make)
    out = cell.module("loops", cell.traffic["loop"]).run(cell, seed, seconds, trace, t_start, device, make)

    numbers, error = out["numbers"], out["error"]
    correct = error is None and out["attempted"] > 0 and out["failed"] == 0
    checks_out = {}
    for name, limit in cell.limits.items():
        value = numbers.get(name, float("nan"))
        correct = correct and value <= limit
        checks_out[name] = {"value": value, "limit": limit}

    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
               "memory_peak_bytes": out["peak"]}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"]}
    if not trace:
        values = out["values"]
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in values}
    else:
        ctx = out["ctx"]
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(cell.metric_dir, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        summary = ctx.get("trace") or {}
        if summary:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
            result["breakdown"] = breakdown(summary)
    result["device"] = dev
    info = {"cell": cell.name, "seed": seed, "setup_s": out["setup_s"], **out["info"]}
    print(json.dumps({"info": info}), file=sys.stderr)
    if error is not None:
        print(f"check failed: {error}", file=sys.stderr)
    for name, c in checks_out.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["gaps"] = {k: v for k, v in numbers.items() if k not in cell.limits}
    result["checks"] = checks_out
    return result


def breakdown(summary: dict, top: int = 10) -> dict:
    """The costliest device operations and the longest idle gaps by the
    host span that was open, each as [name, seconds]."""
    ops = sorted(((n, v[1]) for n, v in summary["by_name"].items()), key=lambda x: -x[1])[:top]
    gaps = sorted(summary["gaps"].items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port's run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))

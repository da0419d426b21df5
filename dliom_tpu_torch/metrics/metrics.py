"""Observability metrics: counter/gauge/histogram families (a copy of
dliom_tpu/metrics/metrics.py; that package cannot be imported without jax).

Counterpart of the reference's `cartographer/metrics/` (Counter, Gauge,
Histogram, FamilyFactory; registered by RegisterAllMetrics, metrics/register.cc
and the per-module Register* hooks). The reference ships Null
implementations by default and a Prometheus exporter under cloud/; here the
default implementation is live (cheap python counters) with a text
exposition dump compatible with Prometheus scraping."""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple


class Counter:
    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def increment(self, by: float = 1.0):
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    def __init__(self):
        self._value = 0.0
        # increment/decrement are used from the main thread and pool
        # workers concurrently (queue_length); unlocked += loses updates
        self._lock = threading.Lock()

    def set(self, value: float):
        with self._lock:
            self._value = value

    def increment(self, by: float = 1.0):
        with self._lock:
            self._value += by

    def decrement(self, by: float = 1.0):
        with self._lock:
            self._value -= by

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bucketed histogram (metrics/histogram.h: FixedWidth / ScaledPowersOf)."""

    def __init__(self, boundaries: Sequence[float]):
        self._bounds = list(boundaries)
        self._counts = [0] * (len(self._bounds) + 1)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    @staticmethod
    def fixed_width(width: float, num_buckets: int) -> List[float]:
        return [width * (i + 1) for i in range(num_buckets)]

    @staticmethod
    def scaled_powers_of(base: float, scale: float, max_value: float) -> List[float]:
        out, v = [], scale
        while v < max_value:
            out.append(v)
            v *= base
        return out

    def observe(self, value: float):
        with self._lock:
            i = bisect.bisect_left(self._bounds, value)
            self._counts[i] += 1
            self._sum += value
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def mean(self) -> float:
        return self._sum / self._n if self._n else 0.0

    def bucket_counts(self) -> List[int]:
        return list(self._counts)


class _Family:
    def __init__(self, name: str, description: str, ctor):
        self.name = name
        self.description = description
        self._ctor = ctor
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}
        self._lock = threading.Lock()

    def add(self, labels: Optional[Dict[str, str]] = None):
        key = tuple(sorted((labels or {}).items()))
        with self._lock:  # first-use from two threads must share one child
            if key not in self._children:
                self._children[key] = self._ctor()
            return self._children[key]

    def items(self):
        return list(self._children.items())


class FamilyFactory:
    """metrics::FamilyFactory analog."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    def new_counter_family(self, name: str, description: str) -> _Family:
        return self._family(name, description, Counter)

    def new_gauge_family(self, name: str, description: str) -> _Family:
        return self._family(name, description, Gauge)

    def new_histogram_family(
        self, name: str, description: str, boundaries: Sequence[float]
    ) -> _Family:
        return self._family(name, description, lambda: Histogram(boundaries))

    def _family(self, name, description, ctor) -> _Family:
        if name not in self._families:
            self._families[name] = _Family(name, description, ctor)
        return self._families[name]

    def dump_text(self) -> str:
        """Prometheus-style text exposition."""
        lines = []
        for fam in self._families.values():
            lines.append(f"# HELP {fam.name} {fam.description}")
            for labels, child in fam.items():
                label_str = ",".join(f'{k}="{v}"' for k, v in labels)
                suffix = f"{{{label_str}}}" if label_str else ""
                if isinstance(child, Histogram):
                    lines.append(f"{fam.name}_count{suffix} {child.count}")
                    lines.append(f"{fam.name}_mean{suffix} {child.mean}")
                else:
                    lines.append(f"{fam.name}{suffix} {child.value}")
        return "\n".join(lines)


_REGISTRY = FamilyFactory()


def global_registry() -> FamilyFactory:
    return _REGISTRY


def register_all_metrics(factory: Optional[FamilyFactory] = None) -> Dict[str, _Family]:
    """metrics::RegisterAllMetrics: the families the engine reports
    (LocalTrajectoryBuilder3D::RegisterMetrics,
    local_trajectory_builder_3d.cc:624-649 + ConstraintBuilder3D::
    RegisterMetrics, constraint_builder_3d.cc:402-434)."""
    f = factory or _REGISTRY
    return {
        "local_slam_latency": f.new_gauge_family(
            "mapping_3d_local_trajectory_builder_latency",
            "Per-scan wall latency (s)",
        ),
        "scan_matcher_cost": f.new_histogram_family(
            "mapping_3d_local_trajectory_builder_costs",
            "Local scan matcher final costs",
            Histogram.scaled_powers_of(2, 0.01, 100),
        ),
        "scan_matcher_residual_distance": f.new_histogram_family(
            "mapping_3d_local_trajectory_builder_residuals_distance",
            "Matcher translation residuals (m)",
            Histogram.scaled_powers_of(2, 0.01, 10),
        ),
        "constraints_searched": f.new_counter_family(
            "mapping_constraints_constraint_builder_3d_searched",
            "Loop constraints searched",
        ),
        "constraints_found": f.new_counter_family(
            "mapping_constraints_constraint_builder_3d_found",
            "Loop constraints found",
        ),
        "constraint_scores": f.new_histogram_family(
            "mapping_constraints_constraint_builder_3d_scores",
            "Loop constraint scores",
            Histogram.fixed_width(0.05, 20),
        ),
        "queue_length": f.new_gauge_family(
            "mapping_constraints_constraint_builder_3d_queue_length",
            "Pending background constraint tasks",
        ),
        "brick_groups_dropped": f.new_gauge_family(
            "mapping_3d_brick_grid_groups_dropped",
            "Cumulative brick-grid groups whose updates were dropped "
            "(apply-capacity overflow or pool-full); nonzero means the "
            "grid capacity model is undersized for the data",
        ),
    }


class RateTimer:
    """Per-sensor rate tracker (common::RateTimer analog,
    collated_trajectory_builder.cc:56-76): ring buffer of event wall/stamp
    times; ComputeRate() = events/sec over the window."""

    def __init__(self, window: int = 100):
        self._window = window
        self._stamps: list = []

    def pulse(self, stamp: float) -> None:
        self._stamps.append(float(stamp))
        if len(self._stamps) > self._window:
            self._stamps.pop(0)

    def rate(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0

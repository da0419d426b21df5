from dliom_tpu_torch.metrics.metrics import (
    Counter,
    FamilyFactory,
    Gauge,
    Histogram,
    global_registry,
    register_all_metrics,
    RateTimer,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "FamilyFactory",
    "global_registry",
    "register_all_metrics",
    "RateTimer",
]

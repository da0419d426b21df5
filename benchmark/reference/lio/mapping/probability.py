"""Occupancy probability <-> integer cell value mapping and odds updates
(port of dliom_tpu/mapping/probability.py; reference
cartographer/mapping/probability_values.{h,cc}).

Cell values are integers in [0, 32767]: 0 is unknown, [1, 32767] maps
linearly onto probabilities [0.1, 0.9]. The float32 expressions are the JAX
package's, operation for operation, so the update tables agree bit for bit.
"""

from __future__ import annotations

import torch

from benchmark.reference.lio.common.device import constant

MIN_PROBABILITY = 0.1
MAX_PROBABILITY = 1.0 - MIN_PROBABILITY
UNKNOWN_VALUE = 0
MAX_VALUE = 32767
_SCALE = (MAX_PROBABILITY - MIN_PROBABILITY) / 32766.0


def odds(probability: torch.Tensor) -> torch.Tensor:
    return probability / (1.0 - probability)


def probability_from_odds(o: torch.Tensor) -> torch.Tensor:
    return o / (o + 1.0)


def clamp_probability(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, MIN_PROBABILITY, MAX_PROBABILITY)


def probability_to_value(p: torch.Tensor) -> torch.Tensor:
    """Probability in [0.1, 0.9] -> int32 value in [1, 32767]
    (BoundedFloatToValue)."""
    p = clamp_probability(torch.as_tensor(p, dtype=torch.float32))
    v = torch.floor(
        (p - MIN_PROBABILITY) * (32766.0 / (MAX_PROBABILITY - MIN_PROBABILITY)) + 0.5
    )
    return (v + 1.0).to(torch.int32)


def value_to_probability(value: torch.Tensor) -> torch.Tensor:
    """Integer value in [0, 32767] -> probability; 0 (unknown) -> 0.1."""
    p = value.to(torch.float32) * _SCALE + (MIN_PROBABILITY - _SCALE)
    return torch.where(value == UNKNOWN_VALUE, MIN_PROBABILITY, p)


def apply_odds(value: torch.Tensor, update_odds: float) -> torch.Tensor:
    """One odds-multiplication update of cell value(s), without the update
    marker (ComputeLookupTableToApplyOdds, probability_values.cc:74-84)."""
    known_p = probability_from_odds(update_odds * odds(value_to_probability(value)))
    unknown_p = probability_from_odds(constant(update_odds, torch.float32, value.device))
    new_p = torch.where(value == UNKNOWN_VALUE, unknown_p, known_p)
    return probability_to_value(clamp_probability(new_p))


def compute_update_table(update_odds: float, device=None) -> torch.Tensor:
    """Full 32768-entry int32 update table (value -> new value)."""
    values = torch.arange(32768, dtype=torch.int32, device=device)
    return apply_odds(values, update_odds)

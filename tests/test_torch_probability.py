"""Parity of dliom_tpu_torch/mapping/probability.py with the JAX package:
the full 32768-entry tables must agree exactly (they drive K1)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dliom_tpu.common.config import load_config
from dliom_tpu.mapping import probability as J
from dliom_tpu_torch.mapping import probability as T

_INS = load_config("basic").trajectory_builder.submaps.range_data_inserter
# basic/bench inserter odds, plus a sweep around them
PROBS = [_INS.hit_probability, _INS.miss_probability, 0.51, 0.6, 0.45, 0.9]


@pytest.mark.parametrize("p", PROBS)
def test_update_table_exact(p):
    o = p / (1.0 - p)
    a = np.asarray(J.compute_update_table(o))
    b = T.compute_update_table(o).numpy()
    assert b.dtype == np.int32 and b.shape == (32768,)
    np.testing.assert_array_equal(a, b)


def test_value_probability_maps_exact():
    v = np.arange(32768, dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(J.value_to_probability(jnp.asarray(v))),
                                  T.value_to_probability(torch.from_numpy(v)).numpy())
    p = np.linspace(0.0, 1.0, 100003, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(J.probability_to_value(jnp.asarray(p))),
                                  T.probability_to_value(torch.from_numpy(p)).numpy())

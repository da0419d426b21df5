"""Phase 8's false loop (PERF.md §6) through both packages' searches.

tests/fixtures/bench_e2e_false_loop.npz holds one pair that
`tools/torch_e2e_accuracy.py --config bench_e2e --pairs` wrote from a run
on an H100: node 86 against submap 2 of bench.py's 5 m circle at
bench_e2e's configuration, which the port's with-initial search accepted
at score 0.453 (min_score 0.45), 7.8 m and 1.58 rad from the true relative
pose. tests/torch_loop_pair.py runs it through the JAX package's
`search_batch_fn` and the port's search bodies on the CPU: both accept it
at the card's score and pose, and both score the node at its true pose
under min_score, so the false loop is the reference's behaviour, which
the port keeps (ROADMAP §3, "The reference's own faults").
"""

from pathlib import Path

import numpy as np
import pytest

import torch_loop_pair as lp
import torch_threads  # noqa: F401  (one torch thread per test process)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "bench_e2e_false_loop.npz"
SCORE_ATOL = 1e-6  # two f32 correlative scores of 256 points, as the card logged it
POSE_ATOL = 1e-5  # m and quaternion components after the GN refinement


@pytest.fixture(scope="module")
def pair():
    jpg, tpg = lp.graphs()
    data = lp.load_pairs(FIXTURE)[0]
    return data, lp.run_pair(jpg, tpg, data), float(jpg.cfg.constraint_builder.min_score)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_the_false_loop_is_found_at_the_cards_score(pair, package):
    data, out, min_score = pair
    got = out[package]
    assert got["found"] and got["score"] >= min_score
    np.testing.assert_allclose(got["score"], data["result"][1], atol=SCORE_ATOL)
    np.testing.assert_allclose(got["q"], data["result"][2:6], atol=POSE_ATOL)
    np.testing.assert_allclose(got["t"], data["result"][6:9], atol=POSE_ATOL)
    assert got["error"][0] > 7.0 and got["error"][1] > 1.5  # m, rad: false


def test_port_and_jax_score_the_pair_alike(pair):
    _, out, min_score = pair
    np.testing.assert_allclose(out["port"]["score"], out["jax"]["score"], atol=SCORE_ATOL)
    np.testing.assert_allclose(out["port"]["q"] + out["port"]["t"], out["jax"]["q"] + out["jax"]["t"],
                               atol=POSE_ATOL)
    for at in ("at_found", "at_true"):
        np.testing.assert_allclose([out["port"][at][k] for k in lp.tld.SCORE_KEYS],
                                   [out["jax"][at][k] for k in lp.tld.SCORE_KEYS], atol=SCORE_ATOL)
    # the true pose lies half outside the cropped high grid and scores under the gate
    assert out["jax"]["at_true"]["score_all"] < min_score and out["jax"]["at_true"]["hi_frac_in"] < 0.6

"""One loop-closure pair through both packages' with-initial searches.

    JAX_PLATFORMS=cpu python3 tests/torch_loop_pair.py PAIRS.npz [--pair I]

PAIRS.npz is what `tools/torch_e2e_accuracy.py --config bench_e2e --pairs`
writes: per INTER constraint the node's clouds, histogram, initial pose
and yaw, the target submap's compressed grids and histogram, the port's
result in that run, and the true relative pose. `run_pair` decompresses
the grids and runs the with-initial search (correlative match, then the
GN refinement) on the JAX package (dliom_tpu/backend/pose_graph.py's
`search_batch_fn`, through a JAX `PoseGraph` at chip_smoke.py's bench_e2e
configuration) and on the port (`search_body("search_initial")` with
`decompress_body`, the bodies its programs capture), and scores the node
at the found pose and at the true pose in both: the port through
tools/torch_loop_debug.py's `score_at_pose`, JAX as tools/loop_debug.py
computes it inline. Prints one JSON line per pair. This module imports
both packages, so it lives with the tests.
"""

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import torch_e2e_accuracy as tea  # noqa: E402
import torch_loop_debug as tld  # noqa: E402
from dliom_tpu.backend.compression import CompressedGrid as JCompressed  # noqa: E402
from dliom_tpu.backend.pose_graph import PoseGraph as JPoseGraph  # noqa: E402
from dliom_tpu.backend.precomputation import lookup, probability_from_byte  # noqa: E402
from dliom_tpu.common.config import load_config as jax_config  # noqa: E402
from dliom_tpu.mapping.grid import cell_index, interpolated_probability  # noqa: E402
from dliom_tpu.transform.rigid import Rigid3 as JRigid3  # noqa: E402
from dliom_tpu_torch.backend import pose_graph as TPG  # noqa: E402
from dliom_tpu_torch.backend.compression import CompressedGrid as TCompressed  # noqa: E402
from dliom_tpu_torch.backend.precomputation import Pyramid  # noqa: E402
from dliom_tpu_torch.common.config import load_config as port_config  # noqa: E402


def load_pairs(path) -> list:
    """[{key: array}] of each pair in a --pairs .npz."""
    data = np.load(path)
    n = len({k.split("_", 1)[0] for k in data.files})
    return [{k.split("_", 1)[1]: data[k] for k in data.files if k.startswith(f"{i}_")} for i in range(n)]


def graphs():
    """(the JAX pose graph, the port's on the CPU) at bench_e2e's config."""
    jcfg, tcfg = jax_config("basic", cs.E2E_OVERRIDES), port_config("basic", cs.E2E_OVERRIDES)
    jpg = JPoseGraph(jcfg.pose_graph, jcfg.trajectory_builder)
    jpg._matcher_fns()
    return jpg, TPG.PoseGraph(tcfg.pose_graph, tcfg.trajectory_builder, device="cpu")


def jax_search(jpg, pair):
    """(found, score, pose (q, t), (g_hi, g_lo, pyramid)) of JAX's search."""
    comp = [JCompressed(jnp.asarray(pair[f"{g}_indices"]), jnp.asarray(pair[f"{g}_values"]),
                        jnp.int32(len(pair[f"{g}_indices"]))) for g in ("high", "low")]
    g_hi, g_lo, pyr = jpg._jit_cache["decompress"](*comp)
    hp, hm, lp, lm, q, t, hist, yaw0 = (jnp.asarray(pair[k])[None] for k in tea.NODE_KEYS)
    found, score, pose = jpg._jit_cache["search_batch"](
        pyr, g_hi, g_lo, hp, hm, lp, lm, JRigid3(q, t), hist, jnp.asarray(pair["submap_hist"]), yaw0,
        min_score=float(jpg.cfg.constraint_builder.min_score))
    return (bool(found[0]), float(score[0]), (np.asarray(pose.rotation[0]), np.asarray(pose.translation[0])),
            (g_hi, g_lo, pyr))


def port_search(tpg, pair):
    """(found, score, pose (q, t), (g_hi, g_lo, pyramid)) of the port's
    search bodies on the CPU."""
    fc_cfg = tpg.cfg.constraint_builder.fast_correlative_scan_matcher
    comp = [TCompressed(torch.from_numpy(pair[f"{g}_indices"]), torch.from_numpy(pair[f"{g}_values"]),
                        torch.tensor(len(pair[f"{g}_indices"]), dtype=torch.int32)) for g in ("high", "low")]
    body = TPG.decompress_body(tpg._hi_spec, tpg._lo_spec, fc_cfg.branch_and_bound_depth,
                               fc_cfg.full_resolution_depth)
    g_hi, g_lo, levels = body((), (comp[0].indices, comp[0].values, comp[1].indices, comp[1].values))[1]
    search = TPG.search_body("search_initial", tpg.cfg.constraint_builder, tpg._hi_spec, tpg._lo_spec)
    inp = [torch.from_numpy(np.asarray(pair[k])[None]) for k in tea.NODE_KEYS]
    out = search((g_hi, g_lo, levels), inp + [torch.from_numpy(pair["submap_hist"])])[1][0].numpy()
    return bool(out[0] > 0.5), float(out[1]), (out[2:6], out[6:9]), (g_hi, g_lo, Pyramid(levels=tuple(levels)))


def jax_score_at_pose(jpg, grids, pair, rel) -> dict:
    """tools/loop_debug.py's inline scores of the node at `rel` (q, t)."""
    hi, lo = jpg._hi_spec, jpg._lo_spec
    g_hi, g_lo, pyr = grids
    rel = JRigid3(jnp.asarray(rel[0], jnp.float32), jnp.asarray(rel[1], jnp.float32))
    hp, hm, lp, lm = (jnp.asarray(pair[k]) for k in tea.NODE_KEYS[:4])
    cells = cell_index(rel.apply(hp), hi.resolution)
    vals = lookup(pyr.levels[0], cells, hi.half)
    inb = jnp.all((cells + hi.half >= 0) & (cells + hi.half < hi.extent), axis=-1) & hm
    n_valid = jnp.maximum(jnp.sum(hm.astype(jnp.float32)), 1.0)
    n_in = jnp.maximum(jnp.sum(inb.astype(jnp.float32)), 1.0)
    lo_cells = cell_index(rel.apply(lp), lo.resolution)
    lo_inb = jnp.all((lo_cells + lo.half >= 0) & (lo_cells + lo.half < lo.extent), axis=-1) & lm
    p_low = interpolated_probability(g_lo, rel.apply(lp), lo)
    n_lo = jnp.maximum(jnp.sum(lm.astype(jnp.float32)), 1.0)
    n_lo_in = jnp.maximum(jnp.sum(lo_inb.astype(jnp.float32)), 1.0)
    out = (probability_from_byte(jnp.sum(jnp.where(hm, vals, 0).astype(jnp.float32)) / n_valid),
           probability_from_byte(jnp.sum(jnp.where(inb, vals, 0).astype(jnp.float32)) / n_in),
           n_in / n_valid, jnp.sum(jnp.where(lm, p_low, 0.0)) / n_lo,
           jnp.sum(jnp.where(lo_inb, p_low, 0.0)) / n_lo_in, n_lo_in / n_lo)
    return {k: float(v) for k, v in zip(tld.SCORE_KEYS, out)}


def port_score_at_pose(tpg, grids, pair, rel) -> dict:
    """tools/torch_loop_debug.py's `score_at_pose` of the node at `rel`."""
    pg = SimpleNamespace(device=torch.device("cpu"), _hi_spec=tpg._hi_spec, _lo_spec=tpg._lo_spec,
                         _decompressed_grids=lambda sid: grids)
    node = SimpleNamespace(**{k: pair[k] for k in tea.NODE_KEYS[:4]})
    return tld.score_at_pose(pg, 0, node, rel)


def _error(pose, true_q, true_t):
    """(translation m, rotation rad) of `pose` against the true pose."""
    q = np.asarray(pose[0], np.float64)
    dot = abs(float(np.dot(q / np.linalg.norm(q), np.asarray(true_q, np.float64))))
    return (float(np.linalg.norm(np.asarray(pose[1], np.float64) - true_t)),
            float(2.0 * np.arccos(min(1.0, dot))))


def run_pair(jpg, tpg, pair) -> dict:
    """Both searches and the scores at the found and the true pose."""
    out = {"pair": [int(x) for x in pair["ids"]], "logged": [float(x) for x in pair["result"][:2]],
           "logged_error": _error((pair["result"][2:6], pair["result"][6:9]), pair["true_q"], pair["true_t"])}
    true = (pair["true_q"].astype(np.float32), pair["true_t"].astype(np.float32))
    for name, (search, score) in {"jax": (jax_search, jax_score_at_pose),
                                  "port": (port_search, port_score_at_pose)}.items():
        pg = jpg if name == "jax" else tpg
        found, s, pose, grids = search(pg, pair)
        out[name] = {"found": found, "score": s, "q": [float(x) for x in pose[0]],
                     "t": [float(x) for x in pose[1]], "error": _error(pose, pair["true_q"], pair["true_t"]),
                     "at_found": score(pg, grids, pair, pose), "at_true": score(pg, grids, pair, true)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pairs")
    ap.add_argument("--pair", type=int, action="append")
    args = ap.parse_args(argv)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    jpg, tpg = graphs()
    pairs = load_pairs(args.pairs)
    out = []
    for i in args.pair or range(len(pairs)):
        out.append(run_pair(jpg, tpg, pairs[i]))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()

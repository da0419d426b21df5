"""The JAX package's scan-matcher LM, iteration by iteration, beside the port's.

    JAX_PLATFORMS=cpu python3 tests/torch_lm_parity.py [--scans 6] [--out PATH] [--late-lane]

`jax_lm_trace` is tools/torch_lm_trace.py's `lm_trace` on the JAX package:
dliom_tpu/ops/scan_matcher.py's `lm_step`, run one iteration at a time
under jit with the package's own `_residuals` and `_apply_delta` through
`jax.linearize`, reading the same quantities. `main` steps the port's CPU
over the tool's bench-config scans from its seeded state; at each scan's
match it traces the port's LM on the CPU (`traced`) and the JAX package's
from the same arguments, carried over with `dliom_tpu_torch/interop.py`,
and prints the tool's `compare` of the port against JAX. `--late-lane`
prints `late_lane_window` instead: where the port and JAX part after an
empty first scan (tests/test_torch_lm_trace.py holds it). This module
imports both packages, so it lives with the tests.
"""

import argparse
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch_lm_trace as tl  # noqa: E402
from dliom_tpu.mapping import brick_grid as JB  # noqa: E402
from dliom_tpu.ops import scan_matcher as JS  # noqa: E402
from dliom_tpu.transform.rigid import Rigid3 as JRigid3  # noqa: E402
from dliom_tpu_torch.interop import to_numpy  # noqa: E402


def to_jax(args, kwargs):
    """One port `match` call's (args, kwargs) on brick grids (the bench
    config's) as the JAX package's."""
    kw = dict(zip(("initial_pose", "clouds", "grids", "specs"), args), **kwargs)
    pose, clouds, grids, specs = (kw.pop(k) for k in ("initial_pose", "clouds", "grids", "specs"))
    if kw.get("target_translation") is not None:
        kw["target_translation"] = jnp.asarray(to_numpy(kw["target_translation"]))
    kw["grid_bases"] = [jnp.asarray(to_numpy(b)) for b in kw.get("grid_bases") or [0] * len(grids)]
    kw.pop("host_exit", None)
    return ((JRigid3(*(jnp.asarray(x) for x in to_numpy(pose))),
             [tuple(jnp.asarray(x) for x in to_numpy(c)) for c in clouds],
             [JB.BrickBank(*(jnp.asarray(x) for x in to_numpy(g))) for g in grids],
             [JB.BrickGridSpec(*s) for s in specs]), kw)


def jax_lm_trace(initial_pose, clouds, grids, specs, *, occupied_space_weights, translation_weight,
                 rotation_weight, target_translation=None, only_optimize_yaw=False, max_iterations=12,
                 grid_bases=None, function_tolerance=0.0) -> dict:
    """The JAX `match`'s LM, one iteration at a time, as `lm_trace`; beside
    JAX's jitted `match` from the same arguments: "equal_to_match" (pose,
    cost and iterations bit for bit), "match_iterations_equal" and
    "match_pose_diff" (XLA fuses one step apart from the loop)."""
    if target_translation is None:
        target_translation = initial_pose.translation
    if grid_bases is None:
        grid_bases = [0] * len(grids)
    ndelta = 4 if only_optimize_yaw else 6
    zero, eye = jnp.zeros(ndelta, jnp.float32), jnp.eye(ndelta, dtype=jnp.float32)

    def r_and_jac(pose):
        r, jvp = jax.linearize(lambda d: JS._residuals(
            JS._apply_delta(pose, d, only_optimize_yaw), clouds, grids, specs, occupied_space_weights,
            target_translation, initial_pose.rotation, translation_weight, rotation_weight, grid_bases), zero)
        return r, jax.vmap(jvp, in_axes=0, out_axes=1)(eye)

    @jax.jit
    def start():
        r0, jac0 = r_and_jac(initial_pose)
        c0 = jnp.sum(r0 * r0)
        return (initial_pose, r0, jac0, c0, jnp.float32(1e4), c0, initial_pose, c0)

    @jax.jit
    def lm_step(carry):
        # dliom_tpu/ops/scan_matcher.py::match's lm_step, with what it reads
        pose, r, jac, cost, radius, ref_cost, best_pose, best_cost = carry
        grad = jac.T @ r
        hess = jac.T @ jac
        d2 = jnp.clip(jnp.diag(hess), 1e-12, 1e32)
        damped = hess + (1.0 / radius) * jnp.diag(d2)
        step = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(damped, lower=True), grad)
        cand = JS._apply_delta(pose, step, only_optimize_yaw)
        cand_r, cand_jac = r_and_jac(cand)
        new_cost = jnp.sum(cand_r * cand_r)
        model_reduction = -(2.0 * step @ grad + step @ (hess @ step))
        rho = (ref_cost - new_cost) / jnp.maximum(model_reduction, 1e-12)
        accept = rho > 1e-3
        sel = lambda a, b: jnp.where(accept, a, b)  # noqa: E731
        shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        is_best = accept & (new_cost < best_cost)
        new = (jax.tree.map(sel, cand, pose), sel(cand_r, r), sel(cand_jac, jac), sel(new_cost, cost),
               jnp.where(accept, jnp.minimum(radius / shrink, 1e6), jnp.maximum(radius * 0.25, 1e-6)),
               jnp.where(accept, 0.5 * ref_cost + 0.5 * new_cost, ref_cost),
               jax.tree.map(lambda a, b: jnp.where(is_best, a, b), cand, best_pose),
               jnp.where(is_best, new_cost, best_cost))
        return new, dict(cost=cost, new_cost=new_cost, rho=rho, radius=radius, grad=grad, hess=hess, step=step,
                         damped=damped, converged=jnp.abs(cost - new_cost) <= function_tolerance * cost)

    carry, rows = start(), []
    for _ in range(max_iterations):
        carry, seen = lm_step(carry)
        host = {k: np.asarray(v, np.float64) for k, v in seen.items() if k != "converged"}
        exact = np.linalg.solve(host.pop("damped"), -host["grad"])
        row = {k: v.tolist() for k, v in host.items()}
        row.update(best_q=np.asarray(carry[6].rotation, np.float64).tolist(),
                   best_t=np.asarray(carry[6].translation, np.float64).tolist(), best_cost=float(carry[7]))
        row["accept"] = bool(row["rho"] > 1e-3)
        row["ratio"] = abs(row["cost"] - row["new_cost"]) / row["cost"]
        row["converged"] = bool(seen["converged"])
        row["solve_err"] = float(np.linalg.norm(host["step"] - exact) / np.linalg.norm(exact))
        rows.append(row)
        if function_tolerance > 0.0 and row["converged"]:
            break
    pose = np.concatenate([np.asarray(carry[6].rotation), np.asarray(carry[6].translation)])
    ref = jax.jit(lambda p: JS.match(
        p, clouds, grids, specs, occupied_space_weights=occupied_space_weights,
        translation_weight=translation_weight, rotation_weight=rotation_weight,
        target_translation=target_translation, only_optimize_yaw=only_optimize_yaw,
        max_iterations=max_iterations, grid_bases=grid_bases,
        function_tolerance=function_tolerance))(initial_pose)
    ref_pose = np.concatenate([np.asarray(ref.pose.rotation), np.asarray(ref.pose.translation)])
    return {"iterations": len(rows), "cost": float(carry[7]), "pose": pose.tolist(), "rows": rows,
            "equal_to_match": bool(np.array_equal(pose, ref_pose) and float(carry[7]) == float(ref.cost)
                                   and len(rows) == int(ref.iterations)),
            "match_iterations_equal": len(rows) == int(ref.iterations),
            "match_pose_diff": float(np.max(np.abs(pose - ref_pose))), "replayed": True}


def trace_both(args, kwargs) -> dict:
    """{"cpu": the port's trace, "jax": JAX's} of one match's arguments."""
    jargs, jkw = to_jax(args, kwargs)
    return {"cpu": tl.traced(args, kwargs), "jax": jax_lm_trace(*jargs, **jkw)}


def late_lane_window() -> dict:
    """The late lane of tests/test_torch_mesh.py::test_batched_presearch_with_a_late_lane
    at its first scan, which has no points, from JAX's fresh state on the
    CPU: "pre_gn", per float field of the sliding window as its GN finds
    it, the largest difference between the port's step (tools/torch_lm_trace.py's
    `step_stages`) and JAX's (its `optimize` left out, so that the step
    returns that window) over the larger of the field's largest magnitude
    and 1, and "pre_gn_ints_equal"; then, from that window, the port's f32
    GN, JAX's f32 GN and the port's GN in float64: "cond" and "solve_err"
    per iteration (`window_trace`: the scaled system's condition number,
    the f32 solve's error relative to a float64 solve of the same system),
    the float64 GN's largest key movement "moved" (m), each f32 GN's
    largest position departure from it ("error", m) and the two f32 GNs'
    largest position gap ("gap", m)."""
    import functools
    import warnings

    import torch

    from dliom_tpu.common.config import load_config as j_load_config
    from dliom_tpu.frontend import lio as JL
    from dliom_tpu.imu import preintegration as JP
    from dliom_tpu.imu import window_optimizer as JW
    from dliom_tpu_torch.common.config import load_config as t_load_config
    from dliom_tpu_torch.imu import window_optimizer as TW
    from dliom_tpu_torch.interop import lio_scan_input_from_numpy, lio_state_from_numpy
    from test_torch_batch import _lane, _overrides, _scans
    from test_torch_mesh import _rtc

    cpu = torch.device("cpu")
    j_cfg = j_load_config("basic", _rtc(_overrides(True))).trajectory_builder
    t_cfg = t_load_config("basic", _rtc(_overrides(True))).trajectory_builder
    scan = _lane(_scans(n_scans=1, start=2, seed=1)[0], 1)
    assert not scan.mask.any()
    jstate = JL.make_lio_state(j_cfg, JP.NavState.identity(), jnp.zeros(3), jnp.zeros(3))
    optimize = JW.optimize
    JW.optimize = lambda win, *a, **k: win  # the step's window as its GN finds it
    try:
        jwin = jax.jit(lambda s, x: JL.lio_step(s, x, j_cfg)[0].window)(jstate, jax.tree.map(jnp.asarray, scan))
    finally:
        JW.optimize = optimize
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stages = tl.step_stages(t_cfg, lio_state_from_numpy(jax.tree.map(np.asarray, jstate), cpu),
                                lio_scan_input_from_numpy(scan, cpu))
    win = stages["window_state"]
    pre_gn, ints_equal = {}, True
    for f, x, y in zip(win._fields, win, jwin):
        x, y = x.numpy(), np.asarray(y)
        if x.dtype.kind == "f":
            pre_gn[f] = float(np.abs(x - y).max() / max(np.abs(y).max(), 1.0))
        else:
            ints_equal &= bool(np.array_equal(x, y))
    imu, g, iters = t_cfg.imu, t_cfg.imu.gravity, t_cfg.gn_iterations
    port = TW.optimize(win, imu, g, iterations=iters)
    traced, rows = tl.window_trace(win, imu, g, iters)
    exact = TW.optimize(type(win)(*(x.double() if x.is_floating_point() else x for x in win)), imu, g,
                        iterations=iters)
    jax_out = jax.jit(functools.partial(optimize, cfg=j_cfg.imu, gravity=g, iterations=iters))(
        type(jwin)(*(jnp.asarray(x.numpy()) for x in win)))
    p64 = exact.p.numpy()
    return {"pre_gn": pre_gn, "pre_gn_ints_equal": ints_equal,
            "trace_equals_optimize": all(bool(torch.equal(a, b)) for a, b in zip(traced, port)),
            "cond": [r["cond"] for r in rows], "solve_err": [r["solve_err"] for r in rows],
            "moved": float(np.abs(p64 - win.p.double().numpy()).max()),
            "error": {"port": float(np.abs(port.p.double().numpy() - p64).max()),
                      "jax": float(np.abs(np.asarray(jax_out.p, np.float64) - p64).max())},
            "gap": float(np.abs(port.p.numpy() - np.asarray(jax_out.p)).max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=6)
    ap.add_argument("--late-lane", action="store_true", help="print `late_lane_window()` and stop")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    if args.late_lane:
        out = late_lane_window()
        print(json.dumps(out), flush=True)
        return out
    cfg, state, inputs = tl.bench_state(args.scans)
    traces = []
    with tl.recording_matches(lambda a, k: traces.append(trace_both(a, k))):
        from dliom_tpu_torch.frontend.lio import lio_step

        for inp in inputs:
            state, _ = lio_step(state, inp, cfg)
    for s, scan in enumerate(traces):
        print(json.dumps({"scan": s, **{n: {"iterations": t["iterations"], "cost": t["cost"],
                                             "equal_to_match": t["equal_to_match"],
                                             "match_pose_diff": t.get("match_pose_diff", 0.0),
                                             "ratios": [r["ratio"] for r in t["rows"]]}
                                         for n, t in scan.items()}}), flush=True)
    out = tl.compare(traces, "jax", "cpu", cfg.ceres_scan_matcher.function_tolerance)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"traces": traces, "compare": out}))
    return out


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The scan matcher's LM, iteration by iteration, on two devices from the same inputs.

    python3 tools/torch_lm_trace.py [--scans 6] [--device cuda] [--out PATH]

At the bench config (`chip_smoke.py`'s BENCH_OVERRIDES: max_num_iterations
6, function_tolerance 1e-3) the LM of `ops/scan_matcher.py::match` may stop
after a different number of iterations on the card than on the CPU. This
tool shows where the two part. From one LIO state (a fresh state at that
config, with chip_smoke.py's spawn capacities, stepped over its WARMUP of
`bench_scans` on the CPU from the seed) the port's CPU steps the next
`--scans` scans with the eager `lio_step`. At each scan's match, `lm_trace`
replays the LM from that match's own arguments on the CPU, on `--device`
under cuSOLVER (the compiled step's linear algebra, `common/graph.py::
cusolver`) and on `--device` with PyTorch's default choice. It records, per
iteration k: the cost and the candidate's cost, |cost - new_cost| / cost
(the convergence test's ratio), rho and the acceptance, the radius, the
gradient, the step and its error against a float64 solve of the same
system, and the best pose. `compare` names the first quantity, in the
order an iteration computes them, that departs between two traces by more
than its bound in BOUNDS, and the margins of the convergence ratio around
the tolerance where the two devices' iteration counts differ. Then, along
the CPU's chain, each scan's step runs on the card too from a copy of the
same pre-step state (`chain_stages`: the preintegration, the relative
prediction, the filter stage's clouds, the match, the window before and
after its GN, the pose and velocity, against STAGE_BOUNDS), with K2's
kernel and again with its plain version, and the window's GN runs from
the CPU's window on both devices (`window_solves`: each f32 solve beside
the float64 solve of the same system). Last, the card steps its own chain
of states from the same state (as chip_smoke.py's phase 14 does), its
iterations per scan beside the CPU chain's.

Prints one JSON line per scan (iterations on each device, every trace
equal to the package's own `match`), then the comparison of each device
with the CPU, the steps' stages and the two chains' iterations; `main`
returns those; `--out` writes them with the full traces as JSON. It imports nothing of JAX: tests/torch_lm_parity.py
traces the JAX package's LM the same way and holds it to the CPU trace
here.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.func import jacfwd
from torch.utils._pytree import tree_map

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dliom_tpu_torch.common.device import get_device  # noqa: E402
from dliom_tpu_torch.ops import scan_matcher as sm  # noqa: E402
from dliom_tpu_torch.transform.rigid import Rigid3  # noqa: E402

# f32 rounding bounds, per quantity, for a trace against another from the
# same inputs (relative unless marked absolute): a cost sums <= 518 squared
# residuals (256 + 256 points and 6 priors), each a trilinear interpolation
# of int16 odds, in whatever order the device reduces them; the gradient
# and the Hessian are 6-column products over the same rows; the step is a
# 6 x 6 damped solve, whose rounding the float64 solve beside it shows; the
# convergence ratio |cost - new_cost| / cost moves by the two costs' bounds;
# the radius moves by 1 / shrink(rho), whose relative slope in rho is at
# most 18 (shrink >= 1/3, |shrink'| <= 6): 18 x rho's bound a step, 6 steps
BOUNDS = {"cost": 1e-5, "grad": 1e-4, "hess": 1e-4, "step": 1e-3, "new_cost": 1e-5, "ratio": 2e-5,
          "rho": 1e-3, "radius": 0.1, "best_pose": 1e-5}
ABSOLUTE = ("ratio", "rho", "best_pose")
ORDER = ("cost", "grad", "hess", "step", "new_cost", "ratio", "rho", "accept", "radius", "best_pose")


def lm_trace(initial_pose, clouds, grids, specs, *, occupied_space_weights, translation_weight,
             rotation_weight, target_translation=None, only_optimize_yaw=False, max_iterations=12,
             grid_bases=None, function_tolerance=0.0, host_exit=False) -> dict:
    """`ops/scan_matcher.py::match` at one lane (its arguments), one LM
    iteration at a time: the package's `_lm_iterate` advances the carry,
    and the iteration's linear algebra is recomputed beside it from the
    same carry with the same operations, to read what the carry does not
    keep. Stops where `match` stops (the first converged iteration when
    function_tolerance > 0). Returns {"iterations", "cost", "pose",
    "replayed" (each candidate equal to `_lm_iterate`'s), "rows": one dict
    per iteration}."""
    del host_exit  # the trace stops where the early exit would
    if target_translation is None:
        target_translation = initial_pose.translation
    if grid_bases is None:
        grid_bases = [0] * len(grids)
    zero = torch.zeros(4 if only_optimize_yaw else 6, dtype=torch.float32,
                       device=initial_pose.translation.device)

    def r_and_jac(pose):
        def residual_at(delta):
            return sm._residuals(sm._apply_delta(pose, delta, only_optimize_yaw), clouds, grids, specs,
                                 occupied_space_weights, target_translation, initial_pose.rotation,
                                 translation_weight, rotation_weight, grid_bases)

        jac, r = jacfwd(lambda d: (residual_at(d),) * 2, has_aux=True)(zero)
        return r, jac

    seen = []

    def lane(cand):
        r, jac = r_and_jac(Rigid3(cand.rotation[0], cand.translation[0]))
        seen.append((cand, r[None]))
        return r[None], jac[None]

    r0, jac0 = r_and_jac(initial_pose)
    carry = sm._lanes(lambda x: x[None], sm._initial_carry(initial_pose, r0, jac0, torch.sum(r0 * r0, dim=-1)))
    rows, replayed = [], True
    for _ in range(max_iterations):
        pose, r, jac, cost, radius, ref_cost = carry[:6]
        grad = (jac.transpose(-1, -2) @ r[..., None])[..., 0]
        hess = jac.transpose(-1, -2) @ jac
        d2 = torch.clamp(torch.diagonal(hess, dim1=-2, dim2=-1), 1e-12, 1e32)
        damped = hess + (1.0 / radius)[:, None, None] * torch.diag_embed(d2)
        chol = torch.linalg.cholesky_ex(damped, check_errors=False).L
        step = -torch.cholesky_solve(grad[..., None], chol)[..., 0]
        mine = sm._apply_delta_rows(pose.rotation, pose.translation, step, only_optimize_yaw)
        carry, _ = sm._lm_iterate(carry, lane, only_optimize_yaw, 1, function_tolerance, host_exit=False)
        cand, cand_r = seen[-1]
        replayed &= torch.equal(mine[0], cand.rotation) and torch.equal(mine[1], cand.translation)
        new_cost = torch.sum(cand_r * cand_r, dim=-1)
        model_reduction = -(2.0 * torch.sum(step * grad, -1) + torch.einsum("bi,bij,bj->b", step, hess, step))
        rho = (ref_cost - new_cost) / torch.clamp(model_reduction, min=1e-12)
        exact = torch.linalg.solve(damped[0].double().cpu(), -grad[0].double().cpu())
        best = carry[6]
        host = {k: v.detach().cpu().double() for k, v in dict(
            cost=cost[0], new_cost=new_cost[0], rho=rho[0], radius=radius[0], grad=grad[0], hess=hess[0],
            step=step[0], best_q=best.rotation[0], best_t=best.translation[0], best_cost=carry[7][0]).items()}
        row = {k: v.tolist() for k, v in host.items()}
        row["accept"] = bool(row["rho"] > 1e-3)
        row["ratio"] = abs(row["cost"] - row["new_cost"]) / row["cost"]
        # the test as `_lm_iterate` makes it, in float32 on the device
        row["converged"] = bool(torch.abs(cost - new_cost)[0] <= function_tolerance * cost[0])
        row["solve_err"] = float(torch.linalg.norm(host["step"] - exact) / torch.linalg.norm(exact))
        rows.append(row)
        if function_tolerance > 0.0 and row["converged"]:
            break
    best = carry[6]
    return {"iterations": len(rows), "cost": float(carry[7][0]), "replayed": bool(replayed),
            "pose": torch.cat([best.rotation[0], best.translation[0]]).detach().cpu().tolist(), "rows": rows}


def to_device(tree, device):
    """Copies of a (nested) tree's tensors on `device`."""
    return tree_map(lambda x: x.to(device, copy=True) if isinstance(x, torch.Tensor) else x, tree)


def traced(args, kwargs, linalg=None) -> dict:
    """`lm_trace` of one match's arguments on their device, with whether it
    ends where the package's `match` does (pose and cost bit for bit,
    iterations equal); `linalg` "cusolver" runs both under the compiled
    step's linear algebra."""
    from dliom_tpu_torch.common import graph as cg

    with cg.cusolver() if linalg == "cusolver" else contextlib.nullcontext():
        t = lm_trace(*args, **kwargs)
        ref = sm.match(*args, **kwargs, host_exit=True)
    pose = torch.cat([ref.pose.rotation, ref.pose.translation]).cpu().tolist()
    t["equal_to_match"] = (t["pose"] == pose and t["cost"] == float(ref.cost)
                           and t["iterations"] == int(ref.iterations))
    return t


@contextlib.contextmanager
def recording_matches(on_match):
    """Within: every `match` of the frontend step calls on_match(args,
    kwargs) before it runs."""
    from dliom_tpu_torch.frontend import local_trajectory_builder as ltb

    match = ltb.match

    def spy(*args, **kwargs):
        on_match(args, kwargs)
        return match(*args, **kwargs)

    ltb.match = spy
    try:
        yield
    finally:
        ltb.match = match


def chain_traces(cfg, state, inputs, targets) -> list:
    """The eager `lio_step` over `inputs` from `state` (on the state's
    device); at each scan's match, `traced` of its arguments on each of
    `targets` ({name: (device, linalg)}, the arguments copied there).
    Returns [{name: trace}] per scan."""
    from dliom_tpu_torch.frontend.lio import lio_step

    out, state = [], to_device(state, state.frontend.pose.translation.device)  # the banks change in place

    def on_match(args, kwargs):
        out.append({name: traced(*to_device((args, kwargs), dev), linalg=linalg)
                    for name, (dev, linalg) in targets.items()})

    with recording_matches(on_match):
        for inp in inputs:
            state, _ = lio_step(state, inp, cfg)
    return out


# per stage of one step, in the order the step computes them, the bound of
# a difference between two devices from the same pre-step state: the IMU
# bridge's preintegrated deltas, Jacobians and covariance (each field's
# largest difference over its largest magnitude) within K2's rtol against
# its plain version, and so the sliding window before and after its GN
# (`imu/window_optimizer.py::optimize`); the rest absolute, m and quaternion
# components: a relative prediction from 40 IMU samples, points deskewed
# out to 60 m
STAGE_BOUNDS = {"preintegrated": 1e-5, "relative_prediction": 1e-5, "filtered": 1e-4, "high": 1e-4,
                "low": 1e-4, "match": 1e-5, "window_in": 1e-5, "window_out": 1e-5, "pose": 1e-5,
                "velocity": 1e-5}
RELATIVE_STAGES = ("preintegrated", "window_in", "window_out")


def step_stages(cfg, state, inp, plain_chain=False) -> dict:
    """One eager `lio_step` with its stages' outputs on the host: the IMU
    bridge's preintegration, its relative prediction, the filter stage's
    clouds (filtered, high, low: points and masks), the match's pose, the
    window's float fields before and after its GN (and, as
    "window_state", the window it starts from), then the step's pose and
    velocity. `plain_chain` runs K2's plain version on CPU copies of its
    inputs in place of the kernel."""
    from dliom_tpu_torch.frontend import local_trajectory_builder as ltb
    from dliom_tpu_torch.frontend.lio import lio_step
    from dliom_tpu_torch.imu import preintegration as pre
    from dliom_tpu_torch.imu import window_optimizer as wo

    rec, filter_scan, match, integrate, chain = {}, ltb.filter_scan, ltb.match, pre.integrate, pre.affine_chain
    optimize = wo.optimize
    host = lambda x: x.detach().to("cpu", copy=True)  # noqa: E731
    pose = lambda p: torch.cat([host(p.rotation), host(p.translation)])  # noqa: E731
    floats = lambda win: [host(x) for x in win if x.is_floating_point()]  # noqa: E731

    def optimized(win, *args, **kwargs):
        rec["window_state"], rec["window_in"] = to_device(win, win.q.device), floats(win)
        out = optimize(win, *args, **kwargs)
        rec["window_out"] = floats(out)
        return out

    def integrated(*args):
        out = integrate(*args)
        rec["preintegrated"] = [host(x) for x in out]
        return out

    def plain(f, q):
        return tuple(x.to(f.device) for x in chain(f.cpu(), q.cpu()))

    def filtered(prev_pose, scan, cfg):
        out = filter_scan(prev_pose, scan, cfg)
        rec["relative_prediction"] = pose(scan.relative_prediction)
        rec.update({k: (host(getattr(out, k).points), host(getattr(out, k).mask)) for k in ("filtered", "high", "low")})
        return out

    def matched(*args, **kwargs):
        out = match(*args, **kwargs)
        rec["match"] = pose(out.pose)
        return out

    ltb.filter_scan, ltb.match, pre.integrate, wo.optimize = filtered, matched, integrated, optimized
    if plain_chain:
        pre.affine_chain = plain
    try:
        _, res = lio_step(state, inp, cfg)
    finally:
        ltb.filter_scan, ltb.match, pre.integrate, pre.affine_chain = filter_scan, match, integrate, chain
        wo.optimize = optimize
    rec.update(pose=pose(res.scan.local_pose), velocity=host(res.velocity))
    return rec


def stage_differences(a: dict, b: dict) -> dict:
    """Per stage of `step_stages`: the largest absolute difference (for
    RELATIVE_STAGES, relative to each field's largest magnitude), and for a
    cloud the count of slots whose validity differs (its points compared
    where both are valid)."""
    out = {}
    for k in STAGE_BOUNDS:
        if k in RELATIVE_STAGES:
            out[k] = {"max": max(float(torch.abs(x - y).max() / torch.clamp(torch.abs(y).max(), min=1e-30))
                                 for x, y in zip(a[k], b[k]))}
        elif isinstance(a[k], tuple):
            both = a[k][1] & b[k][1]
            d = torch.abs(a[k][0] - b[k][0])[both]
            out[k] = {"mask_differs": int((a[k][1] != b[k][1]).sum()), "valid": int(a[k][1].sum()),
                      "max": float(d.max()) if d.numel() else 0.0}
        else:
            out[k] = {"max": float(torch.abs(a[k] - b[k]).max())}
    return out


def first_stage_departure(differences: list):
    """The first (scan, stage) whose difference passes STAGE_BOUNDS (for a
    cloud, any slot whose validity differs), or None."""
    for s, d in enumerate(differences):
        for k in STAGE_BOUNDS:
            if d[k].get("mask_differs", 0) or d[k]["max"] > STAGE_BOUNDS[k]:
                return {"scan": s, "stage": k, **d[k], "bound": STAGE_BOUNDS[k]}
    return None


def window_trace(win, imu_cfg, gravity: float, iterations: int):
    """`imu/window_optimizer.py::optimize` from the window `win`, one GN
    iteration at a time with the same operations, and beside each
    iteration's f32 solve of the Jacobi-preconditioned normal equations
    the float64 solve of the same system: (the final window, [{"cond":
    the system's condition number, "solve_err": the f32 increment's
    departure from the float64 one over its norm, "delta": the increment's
    norm}])."""
    from dliom_tpu_torch.imu import window_optimizer as wo

    n = win.window * wo.KEY_DIM
    dev = win.q.device
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    active = torch.repeat_interleave(torch.arange(win.window, device=dev) < win.num_keys, wo.KEY_DIM)
    rows = []
    for _ in range(iterations):
        s = win
        r, jac = wo._jacobian(lambda d: wo._all_residuals(wo._states_apply_delta(s, d), imu_cfg, gravity), n, dev)
        jac = jac * active[None, :]
        h = jac.T @ jac
        g = jac.T @ r
        d = torch.sqrt(torch.clamp(torch.diagonal(h), min=1e-12))
        hs = h / d[:, None] / d[None, :] + 1e-5 * eye
        gs = g / d
        chol = torch.linalg.cholesky_ex(hs, check_errors=False).L
        raw = -torch.cholesky_solve(gs[:, None], chol)[:, 0] / d
        h64, g64, d64 = (x.detach().double().cpu() for x in (hs, gs, d))
        on = active.cpu()
        exact = (-torch.linalg.solve(h64, g64) / d64)[on]
        rows.append({"cond": float(torch.linalg.cond(h64[on][:, on])), "delta": float(torch.linalg.norm(exact)),
                     "solve_err": float(torch.linalg.norm(raw.double().cpu()[on] - exact)
                                        / torch.clamp(torch.linalg.norm(exact), min=1e-30))})
        delta = torch.where(active, raw, 0.0)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        win = wo._states_apply_delta(win, torch.clamp(delta, -1.0, 1.0))
    return win, rows


def window_solves(win, cfg, device) -> dict:
    """The window GN (`window_trace`) from the window `win` on the CPU and
    on `device` (copies): per device, whether the trace ends where
    `optimize` does (bit for bit) and its iterations' condition numbers and
    solve errors; and the largest relative difference of the two devices'
    windows after it."""
    from dliom_tpu_torch.imu import window_optimizer as wo

    out, ends = {}, {}
    for name, dev in (("cpu", torch.device("cpu")), ("device", device)):
        traced_win, rows = window_trace(to_device(win, dev), cfg.imu, cfg.imu.gravity, cfg.gn_iterations)
        ref = wo.optimize(to_device(win, dev), cfg.imu, cfg.imu.gravity, iterations=cfg.gn_iterations)
        ends[name] = [x.detach().cpu() for x in traced_win if x.is_floating_point()]
        out[name] = {"replayed": all(torch.equal(x, y) for x, y in zip(traced_win, ref)), "rows": rows}
    out["difference"] = max(float(torch.abs(x - y).max() / torch.clamp(torch.abs(y).max(), min=1e-30))
                            for x, y in zip(ends["device"], ends["cpu"]))
    return out


def chain_stages(cfg, state, inputs, device) -> dict:
    """Along the eager `lio_step` chain of `inputs` from `state` on the CPU:
    each scan's `stage_differences` between the CPU's step and the same
    step on `device` from a copy of the same pre-step state ("kernel"),
    again with K2's plain version in place of the kernel there ("plain
    K2"), and `window_solves` from the CPU step's window ("window")."""
    from dliom_tpu_torch.frontend.lio import lio_step

    out, state = {"kernel": [], "plain K2": [], "window": []}, to_device(state, torch.device("cpu"))
    for inp in inputs:
        cpu = step_stages(cfg, to_device(state, state.ba.device), inp)
        for name, plain in (("kernel", False), ("plain K2", True)):
            card = step_stages(cfg, to_device(state, device), to_device(inp, device), plain_chain=plain)
            out[name].append(stage_differences(cpu, card))
        out["window"].append(window_solves(cpu["window_state"], cfg, device))
        state, _ = lio_step(state, inp, cfg)
    return out


def bench_state(scans, device=torch.device("cpu")):
    """(cfg, state, inputs): chip_smoke.py's phase 14 config, a fresh state
    stepped on `device` over its WARMUP of `bench_scans`, and the next
    `scans` inputs."""
    import chip_smoke as cs
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.frontend.lio import lio_step

    cfg = load_config("basic", cs.BENCH_OVERRIDES).override(
        {"trajectory_builder": {"submaps": cs.SPAWN_CAPACITIES}}).trajectory_builder
    scan = cs.bench_scans(device)
    state = cs.fresh_state(cfg, device)
    for i in range(cs.WARMUP):
        state, _ = lio_step(state, scan(i), cfg)
    return cfg, state, [scan(i) for i in range(cs.WARMUP, cs.WARMUP + scans)]


def _diff(name, a, b):
    if name == "accept":
        return float(a["accept"] != b["accept"])
    if name == "best_pose":
        return float(np.max(np.abs(np.subtract(a["best_q"] + a["best_t"], b["best_q"] + b["best_t"]))))
    x, y = np.asarray(a[name]), np.asarray(b[name])
    if name in ABSOLUTE:
        return float(np.max(np.abs(x - y)))
    return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))


def compare(traces, ref, other, tolerance) -> dict:
    """`other`'s traces against `ref`'s over the scans: the largest
    difference of each quantity at each iteration, the first quantity (by
    iteration, then in ORDER) beyond its bound (`accept` departs when it
    flips), and at each scan where the iteration counts differ, the
    convergence ratio of both at the first iteration where one converged,
    beside the tolerance ("at_threshold": both within the ratio's bound
    of it, where rounding alone can flip the exit)."""
    worst, first, flips = {}, None, []
    for s, scan in enumerate(traces):
        a, b = scan[ref], scan[other]
        for k, (ra, rb) in enumerate(zip(a["rows"], b["rows"])):
            for name in ORDER:
                d = _diff(name, rb, ra)
                w = worst.setdefault(name, [])
                w.extend([0.0] * (k + 1 - len(w)))
                w[k] = max(w[k], d)
                if first is None and d > BOUNDS.get(name, 0.0):
                    first = {"quantity": name, "scan": s, "iteration": k + 1, "difference": d,
                             "bound": BOUNDS.get(name, 0.0)}
        if a["iterations"] != b["iterations"]:
            k = min(a["iterations"], b["iterations"]) - 1
            ratios = {ref: a["rows"][k]["ratio"], other: b["rows"][k]["ratio"]}
            flips.append({"scan": s, "iterations": {ref: a["iterations"], other: b["iterations"]},
                          "iteration": k + 1, "tolerance": tolerance, "ratio": ratios,
                          "at_threshold": all(abs(r - tolerance) <= BOUNDS["ratio"] for r in ratios.values()),
                          "cost": {ref: a["rows"][k]["cost"], other: b["rows"][k]["cost"]}})
    return {"ref": ref, "other": other, "first_departure": first, "worst_by_iteration": worst,
            "iteration_flips": flips,
            "iterations": {n: [scan[n]["iterations"] for scan in traces] for n in (ref, other)}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    cfg, state, inputs = bench_state(args.scans)
    targets = {"cpu": (torch.device("cpu"), None)}
    if device.type != "cpu":
        targets.update({f"{device.type}_cusolver": (device, "cusolver"), f"{device.type}_default": (device, None)})
    traces = chain_traces(cfg, state, inputs, targets)
    tol = cfg.ceres_scan_matcher.function_tolerance
    for s, scan in enumerate(traces):
        print(json.dumps({"scan": s, **{n: {"iterations": t["iterations"], "cost": t["cost"],
                                             "equal_to_match": t["equal_to_match"], "replayed": t["replayed"],
                                             "ratios": [r["ratio"] for r in t["rows"]]}
                                         for n, t in scan.items()}}), flush=True)
    out = [compare(traces, "cpu", n, tol) for n in targets if n != "cpu"]
    if device.type != "cpu":
        # the card's own chain from the same state, as phase 14 steps it
        own = chain_traces(cfg, to_device(state, device), to_device(inputs, device),
                           {"own": (device, "cusolver")})
        stages = chain_stages(cfg, state, inputs, device)
        out.append({"stages": stages, "first_stage_departure": {
            k: first_stage_departure(stages[k]) for k in ("kernel", "plain K2")}})
        out.append({"own_chains": {"cpu": [s["cpu"]["iterations"] for s in traces],
                                   device.type: [s["own"]["iterations"] for s in own]},
                    "own_chain_ratios": {"cpu": [[r["ratio"] for r in s["cpu"]["rows"]] for s in traces],
                                         device.type: [[r["ratio"] for r in s["own"]["rows"]] for s in own]}})
    for c in out:
        print(json.dumps(c), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"traces": traces, "compare": out}))
    return out


if __name__ == "__main__":
    main()

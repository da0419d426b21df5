#!/usr/bin/env python3
"""The readings that a cell's limits are set from (benchmark/limits/<cell>.json),
on the card: the program on many seeds (the lower readings), the control
(the reference put in the program's place and computed in TF32, the
nearest precision below the configuration's float32 with TF32 off) and
the faults planted in the program (the upper readings).

    python3 benchmark/control.py --workload viral.replay --seeds 1,2,3 \\
        --systems program,control,unchanged,altered,skip_insert --seconds 2

prints one JSON line a system and seed: its check numbers and `correct`.

    python3 benchmark/control.py --workload viral.replay --seeds 1 --probe 600

instead steps the program 600 steps from each seed's start and prints the
fullest slot of each brick pool and the drop gauges after every step's
growth: the readings each configuration's capacities are sized from.
The benchmark's own runs never run this. The systems: `program`, the
`control` (class Control) and the faults (classes Unchanged, Altered,
Half, SkipInsert), each planted over the cell's own system class.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _restore(dst, src, lanes=None):
    """Copy src's leaves into dst's (the per-lane leaves' lanes `lanes`
    only, where given)."""
    from torch.utils._pytree import tree_flatten

    for d, s in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
        if d is None:
            continue
        if lanes is None:
            d.copy_(s)
        elif d.dim() and d.shape[0] == lanes.stop and d.shape == s.shape:
            d[lanes].copy_(s[lanes])


def _front_slots(state, specs: dict, lanes: int, slots=None):
    """The cells of each lane's front (older, matching) submap on the high
    grid, which every insert writes, or of the given slots: views into the
    brick pool (K1's writes) or the dense values (the per-record insert's),
    and the slots."""
    sm = state.frontend.submaps
    if sm.high_brick is not None:
        pool, per = sm.high_brick.pool, specs["hi_brick"].num_pool_cells
    else:
        pool, per = sm.high_values, specs["hi"].num_cells
    if slots is None:
        created = sm.num_created.reshape(-1).tolist()[:lanes]
        slots = [(n - 2) % 2 if n >= 2 else (n - 1) % 2 for n in created]
    return [pool[(2 * b + s) * per:(2 * b + s + 1) * per] for b, s in enumerate(slots)], slots


class Unchanged:
    """Every step returns its state unchanged (the result is the step's)."""

    def step(self, inp):
        before = self.snapshot()
        super().step(inp)
        _restore(self.state, before)


class Altered:
    """The pose read back is moved 5 cm along x where it is produced."""

    def packed(self):
        out = super().packed().clone()
        out[:, 4] += 0.05
        return out


class Half:
    """The second half of the lanes is left out of every step (their state
    unchanged, their last answers read again)."""

    def step(self, inp):
        before = self.snapshot()
        last = None if self.result is None else self.packed().clone()
        super().step(inp)
        _restore(self.state, before, slice(self.lanes // 2, self.lanes))
        self._stale = last

    def packed(self):
        out = super().packed()
        if getattr(self, "_stale", None) is not None:
            out = out.clone()
            out[self.lanes // 2:] = self._stale[self.lanes // 2:]
        return out


class SkipInsert:
    """The insert leaves each lane's front submap on the high grid as it
    was: K1's writes into that slot's brick pool (or the dense per-record
    insert's into its cells) are undone after every step."""

    def step(self, inp):
        views, slots = _front_slots(self.state, self.specs, self.lanes)
        before = [x.clone() for x in views]
        super().step(inp)
        for d, s in zip(_front_slots(self.state, self.specs, self.lanes, slots)[0], before):
            d.copy_(s)


class _Stepped:
    """The state after a step the control made: the reference's states and
    answers of the checked lanes, and the program's snapshot for the rest."""

    def __init__(self, program, states: dict, answers: dict):
        self.program, self.states, self.answers = program, states, answers


class Control:
    """The control: at each checked step the reference, computed in TF32,
    takes the program's place, from the program's pre-step state (the
    checked lanes; the others are the program's). Between checked steps
    the program steps: an eager reference over every step before the last
    check would take minutes a seed. The check sees only the checked
    steps, each from its own pre-step state, as it does the program's."""

    _ctl = None
    _lanes = None

    def before_checked(self, lanes):
        self._lanes = list(lanes)

    def step(self, inp):
        from benchmark.reference import step as ref

        # the pre-step state the check takes: the control's own where it
        # made the last step too
        pre = self.snapshot(self._lanes) if self._lanes is not None else None
        self._ctl = None
        if self._lanes is None:
            return super().step(inp)
        lanes, self._lanes = self._lanes, None
        super().step(inp)
        cfg = ref.config(self.spec)
        states, answers = {}, {}
        for b in lanes:
            one = inp if self.lanes == 1 else type(inp)(*(x[b] for x in inp))
            states[b], res = ref.step(cfg, ref.convert(self.lane(pre, b)), ref.convert(one), tf32=True)
            answers[b] = ref.pack(res)
        self._ctl = _Stepped(super().snapshot(), states, answers)

    def packed(self):
        out = super().packed()
        if self._ctl is not None:
            out = out.clone()
            for b, row in self._ctl.answers.items():
                out[b] = row
        return out

    def snapshot(self, lanes=None):
        return self._ctl if self._ctl is not None else super().snapshot(lanes)

    def lane(self, snap, b: int):
        if isinstance(snap, _Stepped):
            return snap.states[b] if b in snap.states else super().lane(snap.program, b)
        return super().lane(snap, b)


FAULTS = {"unchanged": Unchanged, "altered": Altered, "half": Half, "skip_insert": SkipInsert,
          "control": Control}


def systems():
    """Each name a factory that turns a cell's system class into what runs
    in its place: the program itself, the control, or a planted fault."""

    def planted(mixin):
        return lambda base: type(f"{mixin.__name__}{base.__name__}", (mixin, base), {})

    return {"program": lambda base: base, **{name: planted(m) for name, m in FAULTS.items()}}


def probe(cell, seed: int, steps: int, device: str) -> dict:
    """The program stepped `steps` steps on the cell's inputs: the most
    groups any slot of each brick pool held, and the drops, after each step."""
    import torch

    from benchmark import generator as gen
    from benchmark.reference import lanes as ref_lanes

    dev = torch.device(device)
    lanes = cell.traffic.get("lanes", 1)
    lap = gen.make_lap(cell.spec, cell.traffic, seed, dev, lanes)
    prog = cell.module("systems", cell.traffic["system"]).System(cell.spec, lanes, dev)
    prog.start(lap.starts)
    most, first_drop, hits = {}, None, 0
    for k in range(steps):
        prog.step(gen.scan_input(lap, k, prog.input_type))
        hits = max(hits, int(prog.packed()[:, 16].max()))
        d = ref_lanes.drops(prog.state)
        for name, v in d.items():
            if name.endswith("_fullest"):
                used, cap = v.split("/")
                most[name] = f"{max(int(used), int(most.get(name, '0/').split('/')[0]))}/{cap}"
            elif v and first_drop is None:
                first_drop = k
    return {"seed": seed, "steps": steps, "fullest": most, "drops": ref_lanes.drops(prog.state),
            "first_drop_step": first_drop, "max_filtered": hits}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--systems", default="program,control")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the tests' small trees)")
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--probe", type=int, default=0, help="steps of a capacity probe (no window, no check)")
    p.add_argument("--submaps", default="{}", help="JSON merged into the probe's submaps overrides")
    args = p.parse_args(argv)
    from benchmark import harness

    if args.probe:
        cell = harness.Cell(args.workload, Path(args.root))
        cell.spec["overrides"].setdefault("trajectory_builder", {}).setdefault("submaps", {}).update(
            json.loads(args.submaps))
        for seed in (int(s) for s in args.seeds.split(",")):
            line = probe(cell, seed, args.probe, "cpu" if args.cpu else "cuda")
            line["submaps"] = json.loads(args.submaps)
            print(json.dumps(line), flush=True)
        return 0

    table = systems()
    for name in args.systems.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            r = harness.run(args.workload, seed, args.seconds, False, t0, system_factory=table[name],
                            require_cuda=not args.cpu, root=Path(args.root))
            line = {"system": name, "seed": seed, "correct": r["correct"],
                    "checks": {k: v["value"] for k, v in r["checks"].items()}, "gaps": r["gaps"],
                    "scans_per_s": r["metrics"].get("scans_per_s", {}).get("value"),
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

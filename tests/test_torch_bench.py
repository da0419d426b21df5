"""bench_torch.py (the port's benchmark) against bench.py: the same configs,
the same ten frontend scans, the same bench_e2e feed, the same JSON keys
and the same gates, and an import that needs neither JAX nor dliom_tpu.

bench.py's heavy parts are stubbed where a test only reads what it builds
(the chunk that would step its scans, the MapBuilder that would map its
feed): recorders take what bench.py hands them and stop the run.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread per test process)

ROOT = Path(__file__).resolve().parents[1]
FED_SCANS = 24  # scans of each bench_e2e feed compared: 16 static, 8 on the circle
POINT_ATOL = 1e-5  # m: the two packages' ray casts of the same pose
FRONTEND_KEYS = ("metric", "value", "unit", "vs_baseline", "brick_groups_dropped",
                 "low_brick_groups_dropped", "dense_groups_dropped")


class _Stop(Exception):
    """Ends a stubbed bench run once its recorder has what it needs."""


def _recording_builder(box, n_scans):
    """A MapBuilder stand-in: keeps its config and keywords, then every IMU
    sample and scan fed to it; stops the run after `n_scans` scans."""

    class Recorder:
        def __init__(self, cfg, **kw):
            box.update(cfg=cfg, kw=kw, imu=[], scans=[])

        def add_imu_data(self, t, acc, gyr):
            box["imu"].append((float(t), np.asarray(acc), np.asarray(gyr)))

        def add_range_data(self, t, pts, ptimes):
            box["scans"].append((float(t), np.asarray(pts), np.asarray(ptimes), len(box["imu"])))
            if len(box["scans"]) >= n_scans:
                raise _Stop

    return Recorder


def _chunk_stubs(box, drops=(0, 0, 0)):
    """bench.py's make_lio_state and make_jit_lio_chunk stubbed: the chunk
    keeps the stacked scans (or, with `box` None, returns at once), the
    joined state carries the given drop gauges."""
    import jax.numpy as jnp

    def chunk(grids, rest, stacked):
        if box is not None:
            box["stacked"] = stacked
            raise _Stop
        res = SimpleNamespace(scan=SimpleNamespace(local_pose=SimpleNamespace(translation=jnp.zeros(3))))
        return grids, rest, res

    gauge = lambda v: SimpleNamespace(dropped=np.asarray([v], np.int32))  # noqa: E731
    sm = SimpleNamespace(high_brick=gauge(drops[0]), low_brick=gauge(drops[1]),
                         dense_dropped=np.asarray([drops[2]], np.int32))
    joined = SimpleNamespace(frontend=SimpleNamespace(submaps=sm))
    make_chunk = lambda cfg, n: (chunk, lambda s: (None, None), lambda g, r: joined)  # noqa: E731
    return (lambda *a, **k: None), make_chunk


@pytest.fixture(scope="module")
def benches():
    """Both benches imported (bench.py's compile-cache settings undone
    afterwards), and what each hands its chunk and its MapBuilder: the ten
    stacked scans, then per config the e2e config and the first FED_SCANS
    scans of the feed."""
    import jax
    from dliom_tpu import map_builder as jmb

    from dliom_tpu_torch import map_builder as tmb

    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    sys.path.insert(0, str(ROOT))
    try:
        import bench
        import bench_torch
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    mp = pytest.MonkeyPatch()
    try:
        box = {}
        mp.setenv("BENCH_E2E", "0")
        mp.setattr(bench, "make_lio_state", _chunk_stubs(box)[0])
        mp.setattr(bench, "make_jit_lio_chunk", _chunk_stubs(box)[1])
        with pytest.raises(_Stop):
            bench.main()
        stacked = box["stacked"]
        fed = {}
        for flagship in (False, True):
            for name, module, run in (
                    ("jax", jmb, lambda: bench.bench_e2e(flagship=flagship)),
                    ("torch", tmb, lambda: bench_torch.bench_e2e(flagship=flagship, device="cpu"))):
                rec = {}
                mp.setattr(module, "MapBuilder", _recording_builder(rec, FED_SCANS))
                with pytest.raises(_Stop):
                    run()
                fed[name, flagship] = rec
    finally:
        mp.undo()
    return SimpleNamespace(jax=bench, torch=bench_torch, stacked=stacked, fed=fed)


def _asdict_diff(a, b, path=""):
    """The paths where two dataclass dicts differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [p for k in sorted(set(a) | set(b))
                for p in _asdict_diff(a.get(k), b.get(k), f"{path}.{k}")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


@pytest.mark.parametrize("which", ["build_config", "e2e", "e2e_flagship"])
def test_configs_equal_bench_py(benches, which):
    """build_config() and both bench_e2e configs, field by field; the
    e2e configs as bench.py hands them to its MapBuilder (the recorder's),
    beside bench_torch.e2e_config and what bench_torch hands its own."""
    if which == "build_config":
        pairs = [(benches.jax.build_config(), benches.torch.build_config())]
    else:
        flagship = which == "e2e_flagship"
        j, t = benches.fed["jax", flagship], benches.fed["torch", flagship]
        pairs = [(j["cfg"], t["cfg"]), (j["cfg"], benches.torch.e2e_config(flagship))]
        assert j["kw"] == {"use_background_threads": True, "pipeline_depth": 1}
        assert t["kw"] == dict(j["kw"], device=torch.device("cpu"))
        sub = t["cfg"].trajectory_builder.submaps
        assert (sub.use_brick_grid, sub.high_resolution_extent, sub.low_resolution_extent) == \
            ((True, 448, 288) if flagship else (False, 128, 64))
    for a, b in pairs:
        diff = _asdict_diff(dataclasses.asdict(a), dataclasses.asdict(b))
        assert not diff, diff[:10]


def test_ten_scans_equal_bench_py(benches):
    """The ten corkscrew scans and their IMU arrays (default_rng(0)):
    times, masks and IMU arrays exact, points within POINT_ATOL."""
    want = benches.stacked
    got = benches.torch.stack_scans(benches.torch.bench_scans(), torch.device("cpu"))
    assert got.points.shape == (10, benches.torch.CAPACITY, 3)
    for f in got._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f == "points":
            np.testing.assert_allclose(b, a, atol=POINT_ATOL, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("flagship", [False, True])
def test_e2e_feed_equals_bench_py(benches, flagship):
    """The first FED_SCANS scans of bench_e2e's feed: every IMU sample's
    stamp and values and every scan's stamp and point times exactly, the
    points within POINT_ATOL, each scan after the same IMU samples."""
    j, t = benches.fed["jax", flagship], benches.fed["torch", flagship]
    assert len(j["scans"]) == len(t["scans"]) == FED_SCANS
    assert len(j["imu"]) == len(t["imu"]) > FED_SCANS
    for (ta, aa, ga), (tb, ab, gb) in zip(j["imu"], t["imu"]):
        assert ta == tb
        np.testing.assert_array_equal(ab, aa)
        np.testing.assert_array_equal(gb, ga)
    for (ta, pa, qa, na), (tb, pb, qb, nb) in zip(j["scans"], t["scans"]):
        assert (ta, na) == (tb, nb)
        assert pa.shape == pb.shape and pa.shape[0] > 0
        np.testing.assert_allclose(pb, pa, atol=POINT_ATOL, rtol=0)
        np.testing.assert_array_equal(qb, qa)


def test_frontend_line_has_bench_py_keys(benches, monkeypatch, capsys):
    """main(device="cpu") at CHUNK 2, WARMUP 1, MEASURE 1 with BENCH_E2E=0
    prints one line with exactly the keys, in the order, of bench.py's
    frontend line (bench.py's own, its chunk stubbed), and no drops."""
    monkeypatch.setenv("BENCH_E2E", "0")
    monkeypatch.delenv("BENCH_E2E_FLAGSHIP", raising=False)
    monkeypatch.setattr(benches.jax, "make_lio_state", _chunk_stubs(None)[0])
    monkeypatch.setattr(benches.jax, "make_jit_lio_chunk", _chunk_stubs(None)[1])
    benches.jax.main()
    want = json.loads(capsys.readouterr().out.strip())
    assert tuple(want) == FRONTEND_KEYS
    for k, v in (("CHUNK", 2), ("WARMUP", 1), ("MEASURE", 1)):
        monkeypatch.setattr(benches.torch, k, v)
    out = benches.torch.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert tuple(got) == FRONTEND_KEYS and got == out
    assert got["metric"] == "lio_scans_per_sec" and got["unit"] == "scans/s" and got["value"] > 0
    assert all(got[k] == 0 for k in FRONTEND_KEYS[4:])


@pytest.mark.parametrize("gate", ["brick", "low_brick", "dense", "inter"])
def test_gates_exit_as_bench_py(benches, monkeypatch, gate):
    """The drop gate on a state whose gauge was raised, and the INTER gate
    on an e2e result without INTER, raise SystemExit with bench.py's
    message (bench.py's own gates, its chunk and bench_e2e stubbed); a
    clean state and a result with an INTER pass."""
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.frontend.lio import make_lio_state
    from dliom_tpu_torch.imu.preintegration import NavState

    b = benches.torch
    if gate == "inter":
        e2e = {"e2e_scans_per_sec": 1.0, "e2e_num_inter_constraints": 0}
        monkeypatch.delenv("BENCH_E2E", raising=False)
        monkeypatch.setattr(benches.jax, "bench_e2e", lambda **kw: dict(e2e))
        drops = (0, 0, 0)
        b.inter_gate({})
        b.inter_gate(dict(e2e, e2e_num_inter_constraints=1))
        with pytest.raises(SystemExit) as got:
            b.inter_gate(e2e)
    else:
        drops = tuple(int(g == gate) for g in ("brick", "low_brick", "dense"))
        monkeypatch.setenv("BENCH_E2E", "0")
        sub = {"use_brick_grid": True, "brick_dir_extent": 8, "brick_max_bricks": 64,
               "brick_apply_groups": 16, "use_brick_grid_low": True, "low_brick_dir_extent": 4,
               "low_brick_max_bricks": 16, "low_brick_apply_groups": 8,
               "high_resolution_extent": 32, "low_resolution_extent": 16}
        cfg = load_config("basic", {"trajectory_builder": {"submaps": sub}}).trajectory_builder
        zero = torch.zeros(3)
        state = make_lio_state(cfg, NavState.identity(), zero, zero)
        clean = b.drop_gauges(state)
        assert clean == dict.fromkeys(FRONTEND_KEYS[4:], 0)
        b.drop_gate(clean)
        sm = state.frontend.submaps
        gauge = {"brick": sm.high_brick.dropped, "low_brick": sm.low_brick.dropped,
                 "dense": sm.dense_dropped}[gate]
        gauge[0] = 1
        with pytest.raises(SystemExit) as got:
            b.drop_gate(b.drop_gauges(state))
    monkeypatch.setattr(benches.jax, "make_lio_state", _chunk_stubs(None)[0])
    monkeypatch.setattr(benches.jax, "make_jit_lio_chunk", _chunk_stubs(None, drops)[1])
    with pytest.raises(SystemExit) as want:
        benches.jax.main()
    assert str(got.value) == str(want.value)


def test_imports_without_jax_or_dliom_tpu():
    """bench_torch and everything it imports need neither jax nor dliom_tpu."""
    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['dliom_tpu'] = None\n"
            f"sys.path.insert(0, {str(ROOT)!r})\nimport bench_torch\nprint('ok')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


def test_needs_a_card_unless_given_the_cpu(benches):
    """Without a card, main and bench_e2e raise through get_device unless
    given device="cpu": there is no quiet CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        benches.torch.main()
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        benches.torch.bench_e2e()

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (dliom_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the exit code is non-zero:

  1. environment: torch and CUDA versions, the card's name and power limit,
     and, for information only, whether msgpack is importable (the port's
     cloud wire carries its own codec and never imports it);
  2. build: compile the CUDA kernels of dliom_tpu_torch/csrc with nvcc;
  3. K1 (grouped grid-update apply) against its plain PyTorch version at
     the bench config's two brick shapes, bit for bit, and both timed;
     then K1_EDGE_CASES at both group sizes, bit for bit (a cell's run
     across 32-, 128- and 1024-record boundaries, hits before and after
     misses, fresh steps with and without records, every step parked,
     dropped ranges, one group); and the graph time of one empty launch
     (csrc/empty.cu), the floor under K1's bounds;
  4. K2 (IMU affine chain) against its plain version, rtol 1e-5 / atol
     1e-6, at M = 32 (the dynamic initializer's padded segment), 48 (the
     bench config), 64 (the default) and 200 (longer than one warp's ring
     of samples), both timed;
 4b. K3 (the window Gauss-Newton, csrc/window_gn.cu) against
     `optimize_plain` at W = 4 (B = 1 and 18) and W = 6, at 8 iterations
     and at 1, each field within its bound (tests/window_cases.py), both
     timed from CUDA graphs beside the bound of K3's dependent chain
     (tools/torch_window_gn_times.py); K3's launches are counted on every
     LIO path below, one a step (`K3_BY_PATH`, the `kernels` line);
  5. the slice: `lio_step` at the bench config (bench.py's
     build_config values, 32768 raw points and 48 IMU samples per scan,
     the synthetic corkscrew with bench.py's IMU recipe), 2 warm-up scans
     then timed scans across a submap spawn; finite poses, no failure, no
     dropped grid updates, kernel launch counts from the timed run, and
     the first 3 scans against the port's own CPU run (plain versions);
  6. where the time goes: torch.profiler over PROFILED more scans after a
     warm-up cycle of as many, per span of the eager lio_step (host time,
     kernel time, launches) and the card's idle share;
 14. (run after 6) the compiled step at the bench config, full width
     (`make_jit_lio_step`, `make_jit_lio_chunk`: CUDA graphs): (a) the first
     step (the eager warm-up) and the capture and instantiation, timed;
     (b) at scans 1, 2 and the spawn, the eager `lio_step` and one replay
     from copies of the same pre-step state: the integer map state (pools,
     directory, counts, epochs, group_of_slot, drop gauges) and the result
     flags bit for bit, the largest pose and velocity differences printed,
     the pose within POSE_ATOL; (c) scans/s over phase 5's timed scans for
     the eager step, the compiled step and the chunk at bench.py's CHUNK,
     the replays' K1 and K2 launches equal to phase 5's eager run, and the
     card's idle share over replays; the eager `lio_step` over EXIT_SCANS
     scans with its LM's fixed trip and with the early exit
     (`match(host_exit=True)`), on the card and on the CPU, timed, the
     poses equal bit for bit; and over the same scans the LM traced
     iteration by iteration on the card and on the CPU from the same match
     arguments (`lm_departure`, tools/torch_lm_trace.py): no quantity
     beyond the tool's f32 bounds, the same iterations unless both ratios
     lie at the threshold.
     Every step held against the eager step, here and in phases 8-11, has
     its integer state bit for bit, its pose within POSE_ATOL and its
     velocity and float state within HELD_ATOL;
  7. K1's dense-bank entry (`apply_grouped_updates`) against its plain
     version at bench_e2e's dense shapes (the 2 x 128^3 high bank and the
     2 x 64^3 low bank, each plus the padding group; 256 steps, 49152
     records), bit for bit, `dropped` included, the padding group
     unchanged: all steps used, steps parked on the padding group (the
     low bank parks most of its steps on every insert), a
     capacity-overflow case and the edge cases (all keys sentinel, one
     group, exactly and one past the capacity, the last real group beside
     the padding group, one group of more than 1024 records, runs of ~750
     records across the kernel's tiles); both timed, and the device
     kernels of one call counted with torch.profiler (exactly 1), with
     their device time per call;
  8. the mapping slice: `MapBuilder` on bench.py's bench_e2e course, its
     circle cut from 5 m to E2E_RADIUS (printed as `reduced`), at
     bench_e2e's config (dense 0.2 m / 0.8 m grids, extents 128 / 64,
     dense_apply_groups 256, 2 background threads, pipeline_depth 1):
     static start, a warm-up of E2E_WARM scans (1.6 laps: the submap that
     holds the revisit finishes, and its search closes the loop; up to
     E2E_WARM_MORE more while no INTER constraint is found), a
     timed stretch, a short profiled window (the card's activity: busy
     time, idle share, the costliest kernels) after a warm-up cycle of the
     same length, `finish_trajectory()`. Checks:
     initialized, finite poses, no failure reset, zero dropped groups, at
     least one INTER constraint, the final optimization ran, K1's dense
     entry launched twice and K2 once per stepped scan (counted through
     the replays), one warm-up and one capture, every other step a replay;
     in a window of steps after the motion starts that runs across a
     submap finish, each step (a replay) against the eager step from the
     same pre-step state on the card (`hold_steps`: integer state bit for
     bit, pose within 2e-3), and every dense K1 call of that eager step
     against its plain version on a CPU copy of the same bank and keys,
     bit for bit (the wrappers do not run in a replay, so the chain is
     graph = eager, eager kernel = plain); and each of the first
     E2E_COMPARE steps, the window's first two and the steps either side of the
     finish, re-run on the CPU (plain versions) from the card's pre-step
     state and input, within 2e-3 of the card's local pose. The course is
     tools/torch_e2e_loop_ate.py's; its `evaluate` (ATE, endpoint error,
     INTER, nodes, submaps), the truth paired with the nodes by node time,
     is printed after the warm-up and after `finish_trajectory()`, then
     each INTER constraint's score and its error against the true relative
     pose (tools/torch_e2e_accuracy.py's `inter_errors`). The
     backend's compiled programs (backend/pose_graph.py: decompress and
     pyramid, the searches with refinement, project, propose, the SPA's
     programs (its rows, J^T J p, CG start, CG step and pose update; one
     shard here), each a CUDA graph captured on its pool thread while the
     frontend replays): their warm-ups, captures and replays, at least one
     capture and one replay of a with-initial search and of the SPA; the
     first HELD_REPLAYS replays of every backend graph held against its
     body run eagerly from copies of the same inputs (`found` and integers
     equal, score, poses within HELD_ATOL), each timed beside its eager
     run; then, with the pool idle, each graph's capture seconds, replay
     device time and kernels, and the device time of copying a cached
     submap's grids into a thread's static grids; the device memory the
     pose graph's programs held, given back when they are dropped (as the
     pose graph that owns them drops them), and what the builder left
     allocated once freed; the `search_*`, `spa` and `compress` phase
     seconds and the mapping rate over a timed stretch that holds at least
     one loop search and one periodic solve, beside the eager backend's
     (PERF.md §5);
  9. the shipped presets' own paths through `MapBuilder`, at their
     published sizes: (a) `campus` as shipped (dense 0.2 m / 0.45 m grids
     of 512^3 / 256^3 cells, per-record insertion, NDT dynamic
     initialization, the gravity factor) on a course that moves from the
     first scan with a time-varying acceleration: initialization in motion
     (up within 0.99, velocity within 0.4 m/s of the truth, the result
     re-run on the CPU from the same buffered inputs within INIT_ATOL; the
     NDT odometry a compiled program: one warm-up and capture, every later
     match a replay, the first HELD_REPLAYS held against the eager
     `build_field` + `ndt_match` from the same inputs; its seconds and the
     initializer's beside the eager ones (PERF.md)),
     then CAMPUS_STEPS stepped scans (printed as `reduced`) (finite, no failure reset, no drops,
     the gravity factor valid), K2 launched exactly once per initializer
     segment and once per stepped scan, the first CAMPUS_COMPARE steps
     re-run on the CPU from the card's pre-step state within 2e-3; (b)
     `viral` as shipped but for num_range_data (high 0.1 m brick grid on
     the per-record insert, `brick_apply_groups` 0) on phase 8's course:
     every high-grid brick insert and slot reset from the first step to
     the first insert with records after the first slot recycle held bit
     for bit against the same call on a CPU copy (directory, pool, counts,
     group_of_slot, dropped, epochs), K2 once per stepped scan; (c)
     `campus` with the online correlative matcher for RTC_STEPS scans:
     each pre-search's best candidate and score on the card against the
     same call on the CPU. In (b) and (c) MapBuilder steps through its
     compiled step, and the calls held are those of the eager step from
     the same pre-step state, itself held against the replay
     (`hold_steps`); (a) prints the peak device memory of the compiled run
     beside one eager step's. The overrides the course forces are printed as `reduced`;
 10. save, resume and reload a map on the card (dliom_tpu_torch/io/): (a) a
     live checkpoint at bench_e2e's config (phase 8's dense grids and
     course, with the truth fed as odometry and fixed-frame positions,
     pipeline_depth 1, no pool threads): builder A runs until its first
     submap has finished and CKPT_AFTER_FINISH scans more, `save_checkpoint`,
     `map_builder_from_checkpoint` into builder B on the card; every tensor
     of B's LioState equals A's bit for bit, the pose graphs are equal
     (poses, compressed grids, node data, constraints, fixed-frame and
     odometry observations, exactly) and so are the trajectory buffers;
     then A and B take the same next CKPT_NEXT scans: B launches K1's dense
     entry twice and K2 once per stepped scan, the counts of nodes, submaps
     and constraints agree, every node and submap histogram is
     bit-identical (the sums are deterministic, ops/segment.py), and so are
     the graphs (or poses within 2e-3, which is reported);
     the checkpoint's bytes and the save and restore times are printed.
     (b) `write_pbstream` of A's graph loaded back on the card with
     `map_builder_from_state(pure_localization=True)`: the same counts,
     every finished submap's grids decompress identically, poses within
     1e-5, the loaded trajectories FROZEN; `write_range_data_pbstream`
     writes nodes + 1 messages. (c) tests/fixtures/reference_map.pbstream,
     written through the reference's own schema, loaded on the card and a
     live revisit from the wrong start (3, -2, 0) localized against it (an
     INTER constraint, the node within 0.4 m of the origin). (d)
     `runner.offline.run` over the synthetic corkscrew on the card with
     state, pbstream and CSV outputs: the JAX runner's report keys, ATE,
     K2 once per stepped scan, the state reloads;
 11. batched LIO on the card (dliom_tpu_torch/parallel/batch.py): (a) the
     bench config at B = 1, 2, 4, 8 sequences in lockstep, each lane on the
     corkscrew in its own world, K1's capacities SPAWN_CAPACITIES x B:
     through the compiled batched step (`make_batched_lio_step`, a CUDA
     graph): BATCH_WARMUP steps (the warm-up and capture), then BATCH_TIMED
     replays: finite poses, no failure reset, zero dropped groups, exactly
     2 K1 and 1 K2 launches per batched step, device kernels per step
     (torch.profiler with the card's activity only, after a warm-up
     cycle, at B = 1 and 8) at B = 8 at most
     1.5 x those at B = 1; aggregate and per-sequence scans/s, K1 and K2
     launches per step and peak device memory per B beside phase 5's
     single-sequence rate (tools/torch_batch_scaling.py --profile prints
     the spans of a batched step). (b) B = 2 at num_range_data 2
     (printed as `reduced`), lane 1's first scan empty so the lanes spawn on
     different steps, across a slot recycle: on every step each lane's pose
     against `lio_step` from that lane's own pre-step state and input on
     the card (2e-3), and the flat 2B-slot insert against each lane's own
     2-slot insert of the same InsertionBatch on a copy of its banks,
     directory, pool, counts, group_of_slot, epochs and dropped bit for bit.
     (c) bench_e2e's dense grids at B = 4 across a spawn through the
     compiled batched step, each step held against the eager batched step
     from the same pre-step state, and that step's K1 dense calls (twice
     per step) each bit-identical to its plain version on a CPU copy.
     (d) (a)'s bench config at B = 8 and (b)'s num_range_data, across
     every lane's spawn and the step after it, through the compiled
     batched step, each step held against the eager batched step from the
     same pre-step state. Phase 3 adds K1 at 16 slots with 8 x the capacities and
     phase 4 K2 at B = 8, M = 48, the batched step's shapes;
 12. the cloud service on the card (dliom_tpu_torch/cloud/), after phase
     11, with phase 10's checkpoint, builder B and B's next CKPT_NEXT scans
     kept for it: builder C restored from that checkpoint on the card
     (pipeline_depth 1, bench_e2e's dense grids, num_range_data
     CKPT_RANGE_DATA, printed as `reduced`) behind a MapBuilderServer on
     127.0.0.1, fed the same scans in feed_with_sensors' order (IMU,
     odometry, range, fixed frame) on trajectory 0 by the port's
     LocalTrajectoryUploader; after the uploader's flush and the server's
     queue drained, C is flushed in-process under the server's lock (the
     wire has no flush RPC). Checks: every LioState tensor of C equals B's
     and so does the pose graph, histograms included, bit for bit (should
     a float tensor differ, it is named, integer state stays exact and node
     poses within 2e-3); K1's dense entry twice and K2 once per stepped
     scan, counted on the SLAM thread; `status` with no error; the uploader
     with no dead letter. Then through the port's MapBuilderStub:
     node_poses, submap_poses, constraints, submap_query of the first
     finished submap (texture bit-identical), occupancy_grid(0.25) and
     map_cloud(0.2) against the same calls in-process on C, metrics,
     write_state loaded back into an equal graph, and finish_trajectory
     over the RPC (the final optimization on the card). Printed: a range
     frame's bytes, the codec's encode and decode ms on the host, the
     served scans' wall time beside B's direct ones (host clock), ping's
     p50 round trip while C steps;
 13. the accuracy tools' paths on the card, after phase 12: (a)
     tools/torch_loop_recall.py's trials 1000-1002 at its own size (5
     places, 8 m of drift beyond the proximity gate and the search window):
     each with proposal recall 1, closure 1 and no false INTER constraint,
     no K1 or K2 launch, through the compiled search programs (each
     trial's pose graph owns its programs: each captured, the decompression
     and the projection replayed, counts printed); trial 1000 again on the CPU: the same proposals
     and INTER submaps, the INTER relative pose within LOOP_REL_ATOL; and
     tools/torch_loop_debug.py's `score_at_pose` of its revisit node at
     its true pose on submap 0, card against CPU within SCORE_ATOL. (b)
     tools/torch_long_course.py's generator at LONG_COURSE_LAPS (laps cut,
     printed as `reduced`), replayed by its `replay` through the runner on
     the card at `course_overrides()` as shipped (256^3 / 192^3 dense
     grids, 8192 nodes, 2 pool threads, pipeline_depth 1): the report's
     ATE keys, as many search latencies as searches, the aligned ATE
     before the final optimization under 0.5 m, `evaluate_constraints`'
     keys, K2 once per stepped scan and K1 never (the course's grids take
     the scatter insert), no drops, no reset, finite poses.
 15. bench_torch.py (bench.py's port), after phase 13: (a) its `main`
     with BENCH_E2E=0 (the compiled chunk of CHUNK 10 over bench.py's ten
     scans, WARMUP 2 and MEASURE 8 chunks): one JSON line with bench.py's
     frontend keys, zero drops, K1 twice and K2 once per scan; (b) its
     flagship config (`bench_torch.e2e_config(flagship=True)`: the 0.1 m
     / 60 m high and 0.45 m low brick grids on the grouped brick K1 at 512
     / 192 groups, backend crops 448^3 / 288^3, 2 pool threads,
     pipeline_depth 1) on phase 8's course, cut as phase 8 cuts it (circle
     E2E_RADIUS, a warm-up of E2E_WARM scans and up to FLAGSHIP_WARM_MORE
     more until an INTER is found, a timed stretch until it holds a search,
     a periodic solve and a submap finish, E2E_PROFILED + E2E_PROFILED
     profiled, `finish_trajectory()`; printed as `reduced`). Checks:
     initialized, finite poses, no failure reset, >= 1 INTER, the final
     optimization ran, K1 (brick) twice and K2 once per stepped scan, the
     compiled step's counts, the first HELD_REPLAYS replays of every
     backend graph (decompress and pyramid at 448^3 included) held against
     its eager body (`hold_backend_graphs`), a window of at most
     FLAGSHIP_WINDOW_MAX steps across a submap finish held against the
     eager step (`hold_steps`) and every grouped brick K1 call of those
     eager steps against plain on a CPU copy, bit for bit. Printed: each
     backend program's capture s, replay device ms and kernels, the grid
     copy-in ms, the programs' memory, the grid cache's, the peak device
     memory, each finished submap's captured cells against the compress
     capacities (1 << 18 high, 1 << 16 low), the drop gauges (bench.py's
     capacities, not gated: bench.py gates only its frontend's), scans/s,
     p50 / p99, phase_seconds and the idle share.
 16. the mesh (`common/mesh.py`), after phase 15: MESH_SHARDS distinct
     cards where the machine has that many, else MESH_SHARDS shards on
     cuda:0 (which runs the sharded code but no cross-card copy; the mesh
     and its distinct devices are printed). (a) `sharded_lio_step` at the
     bench config, MESH_LANES lanes a shard (K1 capacities
     SPAWN_CAPACITIES x MESH_LANES), MESH_WARMUP step, then MESH_HELD
     steps each held shard by shard against the eager batched body from
     the same pre-step state (integers bit for bit, floats within
     HELD_ATOL), then MESH_TIMED timed steps (nothing cloned inside the
     window) beside the unsharded batched step at the same B on the first
     card (aggregate scans/s); K1 2 and K2 1 launches a shard a step,
     counted through the replays (D times a shard's), the step counts, no
     drops, finite poses; (b) the SPA on phase 8's final pose-graph data
     with its node poses perturbed on a fixed seed (MESH_SPA_PERTURB:
     phase 8's final optimization already solved it), its constraint rows
     dealt round the shards so that each holds valid ones, MESH_SPA_ITERATIONS
     GN steps a solve: the eager `solve(mesh=)` and the eager unsharded
     solve; the compiled solves through `PoseGraph._solve` (the SPA's
     programs over the mesh, per-shard CUDA graphs ordered by stream
     events, and the same programs as one shard without a mesh), the
     first call of each (warm-ups and captures) timed apart, then
     MESH_SPA_CALLS calls, every one held against the eager solve of the
     same data and mesh; sharded against unsharded, eager and compiled;
     all within `spa_tolerance` (relative to the solve's movement; its
     derivation there), the solve moving a node by more than
     MESH_SPA_MOVES, each f32 solve's departure from a float64 solve of
     the same problem printed, the programs' counts, ms a GN step for all
     four; (c) phase 8's largest with-initial search chunk (the first of
     them that found a node) through `PoseGraph(mesh=)` against an
     unsharded pose graph: found and score equal, poses within
     MESH_POSE_ATOL (per metre of the largest translation above 1 m: the
     pieces' GN refinement rounds apart in the last f32 bits), the ms of
     a replay of each; (d) `MapBuilder(mesh=)` with its pool threads on
     MESH_BUILDER_SCANS scans of phase 8's course (num_range_data 4 and
     optimize_every_n_nodes 16, so that submaps finish and solves fall
     early; 8 more at a time until the pool ran a search and a solve), its
     compiled-step counts, K1 dense 2 and K2 1 launches a stepped scan,
     finite poses; every search chunk and sharded SPA solve it ran, each
     on a pool thread (streams on every card of the mesh, the search
     programs on every card where a chunk is as wide as the mesh), held
     against an unsharded pose graph on the same inputs: found and score
     equal, poses within MESH_POSE_ATOL per metre, the solves within
     `spa_tolerance`; the SPA programs' warm-ups, captures and replays
     printed, and no eager GN step run; (e) the frontend's compiled
     `sharded_step` (`frontend_mesh_config`: tests/test_torch_mesh.py's
     frontend config with its dense grids on K1's dense entry),
     MESH_LANES lanes a shard, MESH_FRONTEND_STEPS steps, every step of
     every shard held against the eager `batched_step` from copies of the
     same pre-step state (integers bit for bit, floats and poses within
     HELD_ATOL), K1 dense 2 launches a shard a step counted through the
     replays, no drops.

Phase 8 compares step by step, not the free-running CPU trajectory: on
this course an input change of 1e-6 moves the CPU run's fifth local pose
by 1e-2 (PERF.md, Findings), so a free-running comparison would
measure that sensitivity, not the port. For the same reason the banks are
compared at K1's dense entry, from the card's own inputs: a CPU step
inserts at a pose that differs from the card's in the last bits.

Kernel times (phases 3, 4 and 7): `ms` is the host clock around one call
with a synchronize either side (median of REPEATS); `event_ms` is CUDA
events around EVENT_LAUNCHES back-to-back calls after a warm-up, per call
(the card waits on the host where the wrapper's dispatch is the slower);
`graph_ms` is the same calls captured in one CUDA graph and replayed, per
call: device time without host dispatch. `bound_ms` is the least time the
card could take for the work of those inputs: bytes (each input read once,
each output written once, counted from the data) over 3.35 TB/s, or
float32 operations over 67 TFLOP/s, whichever is larger.

Phase 8's timed stretch is not bench.py's full lap (the whole script must
stay well inside its time limit, PERF.md says so): it runs E2E_TIMED scans,
then 8 more at a time until a loop search and a periodic SPA solve have
both ended inside it (at most E2E_TIMED_MAX), so that its rate holds the
backend's replays on the pool threads beside the frontend's.

Scan stamps are spaced 0.6 s apart so the motion filter (max_time_seconds
0.5) admits every scan and the run reaches num_range_data = 100 inserts.
bench.py's apply capacities (512 high / 192 low groups per insert) hold one
active submap; after a spawn both active submaps take every scan, which
touches about twice the groups, so this run sets 1024 / 384. They are
capacity knobs: a run without drops inserts the same map at any capacity.
K1 is checked at both pairs of shapes.

Every phase prints its seconds, and the script its total. Every phase
that steps a MapBuilder prints and checks its compiled step's counts:
one warm-up and one capture per trajectory, every other stepped scan a
replay. The launch counters count what a replay launches: each graph adds
the launches its capture recorded (common/graph.py).

The line before the last is the per-kernel JSON record ({"kernels": [...]});
the last line is {"ok": true, "device": {...}}. Imports nothing of JAX and
never msgpack.
"""

import collections
import gc
import importlib.util
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))  # the port's tools/torch_*.py

CAPACITY = 32768  # raw points per scan
IMU_CAP = 48
WARMUP = 2
TIMED = 104  # crosses the spawn at the 100th inserted scan
CHUNK = 10  # bench.py's scans per make_jit_lio_chunk call (phase 14)
EXIT_SCANS = 6  # phase 14: eager scans per run timing the LM's early exit against its fixed trip
COMPARE = 3  # scans compared with the CPU run
POSE_ATOL = 2e-3  # m and quaternion components, as tests/test_torch_lio.py
HELD_ATOL = 1e-6  # graph vs eager: velocity (m/s), and each float state leaf relative to its
# largest magnitude where that is over 1; both run the same kernels and have read exactly 0
REPEATS = 25
EVENT_LAUNCHES = 200  # calls per CUDA-event timing (phases 3, 4, 7)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores, the same
K2_LENGTHS = (32, 48, 64, 200)  # IMU samples per chain: initializer, bench config, default, long
PROFILED_CALLS = 20  # dense-entry calls under torch.profiler (phase 7)
PROFILED = 1  # scans under torch.profiler after the timed run (phase 6): ~20 s a scan to read
E2E_STATIC = 16  # bench.py: round(1.6 / scan_period) stationary scans
E2E_RADIUS = 2.0  # m: bench.py's circle is 5 m; cut so that the warm-up's revisit fits the limit
E2E_WARM = 134  # 1.6 laps of 84 scans: the third submap (nodes 32-63) finishes, its revisit
# nodes searched against the first (bench.py: 1.12 laps of the 5 m circle, 235 scans)
E2E_WARM_MORE = 32  # at most this many more, 8 at a time, while no INTER constraint is found
E2E_TIMED = 10  # bench.py times a full lap (209 scans); cut to fit the limit, then
E2E_TIMED_MAX = 120  # lengthened to hold a search and a periodic solve (a submap finishes
# every ~32 scans here, a solve runs every 32 nodes, ~64 scans)
E2E_PROFILED = 2  # scans under torch.profiler after the timed stretch
E2E_COMPARE = 5  # local poses compared with the port's CPU run
E2E_BANK_FROM = 80  # the bank window starts here (steps; the motion starts at step 8)
E2E_BANK_MAX = 60  # steps, enough for a submap finish (every ~32 steps here)
CAMPUS_V0 = 0.5  # m/s along x at the first scan: the course starts in motion
CAMPUS_STEPS = 20  # stepped scans after the dynamic initialization
CAMPUS_COMPARE = 3  # steps re-run on the CPU from the card's pre-step state
INIT_ATOL = 1e-2  # card vs CPU initializer result: six chained NDT solves
CAMPUS_PROFILED = 2  # stepped scans under torch.profiler, after a warm-up cycle as long
VIRAL_MOVING = 16  # moving scans after phase 8's E2E_STATIC static ones
VIRAL_RANGE_DATA = 3  # inserts per submap: the course makes ~14 inserts
RTC_STEPS = 5  # stepped scans with the online correlative pre-search
RTC_SCORE_ATOL = 1e-6
CKPT_RANGE_DATA = 4  # bench_e2e ships 16: the first submap finishes after 2 x this many inserts
CKPT_AFTER_FINISH = 3  # scans fed after the first submap finishes, then the checkpoint
CKPT_NEXT = 6  # scans fed to builders A and B after the checkpoint
PHASE10_AIM_S = 120.0
BATCHES = (1, 2, 4, 8)  # phase 11 (a): sequences per batched step
BATCH_WARMUP = 1  # phases 5-10 ran the single-lane step's kernels before
BATCH_TIMED = 4
BATCH_COUNTED = 1  # batched steps whose device kernels are counted, after a warm-up cycle as long
BATCH_LAUNCH_RATIO = 1.5  # device kernels per step at the largest B over B = 1, at most
LANE_OFFSET = np.array([0.25, -0.15, 0.05], np.float32)  # m: lane b's world is offset b times this
LANES_RANGE_DATA = 2  # phase 11 (b): bench.py ships 100; 2 spawns and recycles within LANES_STEPS
LANES_STEPS = 6  # lane 0 recycles a slot at step 4, lane 1 (first scan empty) at step 5
DENSE_LANES = 4  # phase 11 (c)
DENSE_LANES_RANGE_DATA = 2  # bench_e2e ships 16: a spawn at the third step
DENSE_LANES_STEPS = 3
BRICK_LANES_STEPS = 5  # phase 11 (d): the lanes' first submap finishes at step 3, the next step recycles
PHASE11_AIM_S = 120.0
PHASE12_AIM_S = 30.0
CLOUD_DEADLINE_S = 300.0  # phase 12: the served scans must be acknowledged and stepped within this
LOOP_TRIAL_SEEDS = (1000, 1001, 1002)  # phase 13 (a): tools/torch_loop_recall.py's first three trials
LOOP_REL_ATOL = 1e-3  # m and rad: trial 1000's INTER relative pose, card vs CPU
SCORE_ATOL = 1e-5  # score_at_pose, card vs CPU
LONG_COURSE_LAPS = 0.01  # phase 13 (b): tools/torch_long_course.py ships 2.0 laps (~2670 scans)
LONG_COURSE_SEED = 11
PHASE13_AIM_S = 120.0
FIXTURE = "tests/fixtures/reference_map.pbstream"
FIXTURE_OVERRIDES = {  # tests/test_pose_graph.py::_cfg, the fixture's grid specs
    "trajectory_builder": {"submaps": {"high_resolution": 0.2, "low_resolution": 0.8,
                                       "high_resolution_extent": 128, "low_resolution_extent": 64}},
    "pose_graph": {
        "optimize_every_n_nodes": 0, "max_submaps": 16, "max_nodes": 128, "max_constraints": 512,
        "max_radius_enable_loop_detection": 10.0, "num_close_submaps_loop_with_initial_value": 5,
        "constraint_builder": {
            "min_score": 0.4, "every_nodes_to_find_constraint": 1,
            "fast_correlative_scan_matcher": {
                "branch_and_bound_depth": 6, "full_resolution_depth": 3,
                "min_low_resolution_score": 0.35, "linear_xy_search_window": 3.0,
                "linear_z_search_window": 1.5}}},
}
# the keys of the JAX package's runner report on a dataset with ground truth
# and these outputs (dliom_tpu/runner/offline.py:264-402)
RUNNER_REPORT_KEYS = ("map_frame", "tracking_frame", "num_scans", "num_matched", "num_nodes",
                      "num_submaps", "num_constraints", "num_loop_constraints", "wall_seconds",
                      "scans_per_sec", "scan_latency_ms", "phase_seconds", "trajectory_csv",
                      "pbstream_file", "state_file", "ate_rmse_m", "ate_rmse_aligned_m",
                      "pre_optimization_ate_rmse_m", "pre_optimization_ate_rmse_aligned_m")
SPANS = ("lio.preintegrate", "frontend.filter", "frontend.match", "lio.window",
         "frontend.insert", "frontend.histogram")
G = 9.80511

BENCH_OVERRIDES = {
    # bench.py build_config (the VIRAL-faithful bench config)
    "trajectory_builder": {
        "scan_period": 0.1,
        "voxel_filter_size": 0.3,
        "enable_gravity_factor": False,
        "submaps": {
            "high_resolution": 0.1,
            "high_resolution_max_range": 60.0,
            "low_resolution": 0.45,
            "num_range_data": 100,
            "use_brick_grid": True,
            "brick_dir_extent": 160,
            "brick_max_bricks": 65536,
            "brick_apply_groups": 512,
            "dense_apply_groups": 256,
            "high_resolution_extent": 448,
            "low_resolution_extent": 128,
            "use_brick_grid_low": True,
            "low_brick_dir_extent": 40,
            "low_brick_max_bricks": 8192,
            "low_brick_apply_groups": 192,
            "low_brick_apply_group_bricks": 8,
        },
        "max_filtered_points": 8192,
        "max_high_res_points": 256,
        "max_low_res_points": 256,
        "max_imu_per_scan": IMU_CAP,
        "window_size": 6,
        "gn_iterations": 3,
        "ceres_scan_matcher": {"max_num_iterations": 6, "function_tolerance": 1e-3},
    }
}
# bench.py bench_e2e (the dense end-to-end config) with dense grouped apply
E2E_OVERRIDES = {
    "trajectory_builder": {
        "scan_period": 0.1,
        "frames_for_static_initialization": 8,
        "enable_ndt_initialization": False,
        "submaps": {"high_resolution": 0.2, "low_resolution": 0.8,
                    "high_resolution_extent": 128, "low_resolution_extent": 64,
                    "num_range_data": 16, "dense_apply_groups": 256},
        "max_filtered_points": 8192,
        "max_high_res_points": 256,
        "max_low_res_points": 256,
    },
    "pose_graph": {
        "optimize_every_n_nodes": 32,
        "max_submaps": 32,
        "max_nodes": 512,
        "max_constraints": 2048,
        "max_radius_enable_loop_detection": 10.0,
        "num_close_submaps_loop_with_initial_value": 5,
        "constraint_builder": {"min_score": 0.45, "every_nodes_to_find_constraint": 2,
                               "max_nodes_per_search_dispatch": 4},
    },
    "map_builder": {"num_background_threads": 2},
}
# two active submaps after a spawn: twice bench.py's apply capacities
SPAWN_CAPACITIES = {"brick_apply_groups": 1024, "low_brick_apply_groups": 384}


# K3's launches (imu/window_optimizer.py's LAUNCHES) on each main path, as
# its phase counts them: one a LIO step, eager or replayed, every lane in it.
K3_BY_PATH = {}


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def timed_median(fn, repeats=REPEATS):
    """Median wall time in ms of fn(), each run bracketed by synchronize."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def event_ms(fn, launches=EVENT_LAUNCHES):
    """Per call: CUDA events around `launches` back-to-back calls of fn()
    after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def graph_ms(fn, launches=EVENT_LAUNCHES):
    """Per call: `launches` calls of fn() captured in one CUDA graph, whose
    replay is timed with CUDA events (no host dispatch inside). A dense K1
    call takes look-back scratch the graph owns (`lookback_owner`), made by
    the eager call before the capture."""
    from dliom_tpu_torch.ops import grouped_apply as ga

    scratch = ga.LookbackScratch()
    with ga.lookback_owner(scratch):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def bound(nbytes, flops=0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_bytes(starts, ends, keys, fresh, cpg):
    """Bytes K1 must move for these tables: 16 per step (rows, starts, ends,
    fresh), each record read once (4), and per step each distinct touched
    cell read and written (2 + 2), or its whole group written once (2 per
    cell) when the step is fresh."""
    s, e, k, f = (x.cpu().numpy() for x in (starts, ends, keys, fresh))
    total = 16 * len(s)
    for a, b, fr in zip(s, e, f):
        total += 4 * max(0, b - a)
        if fr:
            total += 2 * cpg
        elif b > a:
            total += 4 * len(np.unique((k[a:b] >> 1) & (cpg - 1)))
    return total


def k1_dense_bytes(keys, num_groups, cpg, cb):
    """Bytes K1's dense entry must move: every key read once (4), each
    distinct touched cell of the kept groups read and written (2 + 2),
    `dropped` written (4)."""
    k = keys.cpu().numpy()
    k = k[k != 2**31 - 1]
    kept = np.unique(k >> cb)[:num_groups]
    k = k[np.isin(k >> cb, kept)]
    return 4 * keys.numel() + 4 * len(np.unique(k >> 1)) + 4


def k2_work(batch, m):
    """(bytes, float32 operations) of the chain: F and Q read, A and P
    written; per sample three 15x15 products (2 x 15^3 each) and Q's add."""
    return 2 * batch * (m + 1) * 225 * 4, batch * m * (6 * 15 ** 3 + 225)


def device_events(events):
    """The device-side activities of a profile (kernels, copies, sets),
    without the projections of host spans onto the device timeline."""
    from torch.autograd import DeviceType

    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA and e.name not in host_names
            and not getattr(e, "is_user_annotation", False)]


def timings(fn, plain):
    """The kernel's `ms`, `event_ms` and `graph_ms`, and the plain
    version's `plain_ms` (host clock, as `ms`)."""
    return {"ms": timed_median(fn), "event_ms": event_ms(fn), "graph_ms": graph_ms(fn),
            "plain_ms": timed_median(plain)}


def fmt_times(t):
    return (f"kernel {t['ms']:.4f} ms (events {t['event_ms']:.4f} ms, graph {t['graph_ms']:.4f} ms), "
            f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']})")


def environment():
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    # for information: the port's cloud wire carries its own codec and never imports msgpack
    print(f"msgpack importable: {importlib.util.find_spec('msgpack') is not None}")
    return card


def grouped_apply_case(rng, cells_per_group, num_groups, num_steps, num_records, real_steps):
    """A bank and one insert's tables at a bench shape: sorted records with
    duplicate cells and mixed hit/miss, fresh steps, and empty-range steps
    (parking and mid-sequence drops) sharing the parking row."""
    bank = rng.integers(0, 32768, num_groups * cells_per_group, dtype=np.int16)
    park = num_groups - 1
    rows = np.full(num_steps, park, np.int32)
    rows[:real_steps] = rng.choice(park, real_steps, replace=False)
    rows[rng.choice(real_steps, 8, replace=False)] = park  # pool-full drops
    fresh = np.zeros(num_steps, np.int32)
    fresh[rng.choice(np.flatnonzero(rows != park), 16, replace=False)] = 1
    counts = np.where(rows != park, rng.multinomial(num_records, np.ones(num_steps) / num_steps), 0)
    keys, starts, ends = [], [], []
    for n in counts:
        starts.append(len(keys))
        cells = rng.integers(0, cells_per_group // 4, n) * 4  # duplicates
        keys.extend(sorted((cells << 1) | rng.integers(0, 2, n)))
        ends.append(len(keys))
    keys = np.asarray(keys + [2**31 - 1] * (num_records - len(keys) + 1), np.int32)
    return [torch.from_numpy(x).cuda() for x in
            (bank, rows, np.asarray(starts, np.int32), np.asarray(ends, np.int32), keys, fresh)]


# K1's edge cases (phase 3, tests/test_torch_grouped_apply.py and
# tests/test_torch_cuda_kernels.py): per grid step (kind, fresh, runs).
# "row" steps own distinct rows; "park" steps have an empty range on the
# parking row; "drop" steps park too, but their records stay in the keys
# between the others' ranges (a pool-full drop). Each run is one cell's
# records, at ascending cells: (length, order), order "hits_first" (the
# brick keys' order), "hits_last" (the sorted dense keys') or "misses".
K1_EDGE_CASES = {
    "run_across_32": [("row", 0, [(20, "misses"), (40, "hits_first"), (3, "hits_last")])],
    "run_across_128": [("row", 0, [(100, "hits_first"), (60, "hits_last"), (130, "hits_first")])],
    "run_across_1024": [("row", 0, [(1000, "hits_last"), (100, "hits_first")]),
                        ("row", 0, [(5, "misses")])],
    "hits_first_and_last": [("row", 0, [(6, "hits_first"), (6, "hits_last"), (1, "hits_first"),
                                        (1, "misses"), (9, "hits_last")]),
                            ("row", 0, [(7, "misses"), (2, "hits_first")])],
    "fresh": [("row", 1, [(5, "hits_first"), (3, "misses")]), ("row", 1, []),
              ("row", 0, [(4, "hits_last")]), ("park", 0, [])],
    "all_parked": [("park", 0, [])] * 6,
    "one_group": [("row", 0, [(50, "hits_last"), (3, "hits_first")])],
    "dropped_ranges": [("row", 0, [(10, "hits_first")]), ("drop", 0, [(30, "misses"), (5, "hits_first")]),
                       ("row", 1, [(8, "hits_last")]), ("drop", 0, [(12, "hits_last")]), ("park", 0, [])],
}


def k1_edge_case(name, rng, cells_per_group, groups):
    """Bank and tables (numpy) of one K1_EDGE_CASES case on a bank of
    `groups` groups whose last is the parking row, keys sentinel-padded."""
    bank = rng.integers(0, 32768, groups * cells_per_group, dtype=np.int16)
    park = groups - 1
    steps = K1_EDGE_CASES[name]
    own = iter(rng.choice(park, len(steps), replace=False))
    rows, fresh, starts, ends, keys = [], [], [], [], []
    for kind, fr, runs in steps:
        rows.append(int(next(own)) if kind == "row" else park)
        fresh.append(fr)
        starts.append(len(keys))
        cells = np.sort(rng.choice(cells_per_group, len(runs), replace=False))
        for cell, (length, order) in zip(cells, runs):
            hits = 0 if order == "misses" else max(1, length // 3)
            kinds = [1] * hits + [0] * (length - hits)
            keys.extend((int(cell) << 1) | k for k in (kinds if order == "hits_first" else kinds[::-1]))
        ends.append(len(keys) if kind == "row" else starts[-1])
    keys = np.asarray(keys + [2**31 - 1] * 5, np.int32)
    return bank, *(np.asarray(x, np.int32) for x in (rows, starts, ends)), keys, np.asarray(fresh, np.int32)


def check_grouped_apply(ga, rng):
    hit_odds, miss_odds = 0.55 / 0.45, 0.49 / 0.51
    out = {}
    # (cells_per_group, pool groups over both slots, steps, steps with
    # records): high and low bricks at bench.py's and at the spawn capacities
    for tag, cpg, groups, steps, real, records in (
            ("high", 16384, 2 * 2048, 512, 440, 49152),
            ("low", 4096, 2 * 1024, 192, 170, 49152),
            ("high_spawn", 16384, 2 * 2048, 1024, 900, 49152),
            ("low_spawn", 4096, 2 * 1024, 384, 260, 49152),
            # phase 11's batched step at B = 8: 16 slots, 8 x the capacities
            ("high_batch8", 16384, 16 * 2048, 8 * 1024, 8 * 900, 8 * 49152),
            ("low_batch8", 4096, 16 * 1024, 8 * 384, 8 * 260, 8 * 49152)):
        bank, rows, starts, ends, keys, fresh = grouped_apply_case(rng, cpg, groups, steps, records, real)
        kw = dict(cells_per_group=cpg, hit_odds=hit_odds, miss_odds=miss_odds, fresh=fresh)
        k = ga.apply_grouped_rows(bank.clone(), rows, starts, ends, keys, **kw)
        p = ga.apply_grouped_rows_plain(bank.clone(), rows, starts, ends, keys, **kw)
        torch.cuda.synchronize()
        err = int((k.int() - p.int()).abs().max())
        check(torch.equal(k, p), f"K1 {tag}: kernel bank differs from plain ({err})")
        check(not torch.equal(k, bank), f"K1 {tag}: nothing changed")
        work = bank.clone()
        t = timings(lambda: ga.apply_grouped_rows(work, rows, starts, ends, keys, **kw),
                    lambda: ga.apply_grouped_rows_plain(work, rows, starts, ends, keys, **kw))
        t["bound_ms"], t["bound_by"] = bound(k1_bytes(starts, ends, keys, fresh, cpg))
        t["rmw_probe_ms"] = rmw_probe_ms(work, rows, starts, ends, keys, fresh, cpg)
        print(f"K1 grouped_apply {tag}: cpg {cpg} steps {steps} records {int(ends[-1])}: "
              f"bit-identical; {fmt_times(t)}; the same cells' read-modify-write in PyTorch: "
              f"graph {t['rmw_probe_ms']:.4f} ms")
        out[tag] = dict(t, max_abs_err=err)
    for cpg, groups in ((16384, 2 * 2048), (4096, 2 * 1024)):
        for name in K1_EDGE_CASES:
            bank, rows, starts, ends, keys, fresh = (
                torch.from_numpy(x).cuda() for x in k1_edge_case(name, rng, cpg, groups))
            kw = dict(cells_per_group=cpg, hit_odds=hit_odds, miss_odds=miss_odds, fresh=fresh)
            k = ga.apply_grouped_rows(bank.clone(), rows, starts, ends, keys, **kw)
            p = ga.apply_grouped_rows_plain(bank.clone(), rows, starts, ends, keys, **kw)
            torch.cuda.synchronize()
            check(torch.equal(k, p), f"K1 edge case {name} (cpg {cpg}): kernel bank differs from plain")
            check(torch.equal(k, bank) == (name == "all_parked"), f"K1 edge case {name}: bank changed")
        print(f"K1 grouped_apply edge cases at cpg {cpg}, {groups} groups: {', '.join(K1_EDGE_CASES)}: "
              "bit-identical")
    floor = launch_floor_ms(ga)
    if floor is not None:
        print(f"one empty launch (csrc/empty.cu): graph {floor:.4f} ms, the floor under every K1 bound above")
    return out, floor


def rmw_probe_ms(bank, rows, starts, ends, keys, fresh, cpg):
    """Graph time of the memory traffic K1 cannot avoid, in plain PyTorch:
    each distinct cell of the non-fresh steps read, looked up in a table and
    written back (4 kernels: gather, widen, lookup, scatter), on `bank`'s
    cells at the same positions. Not K1's function; a probe of what the
    scattered 2-byte accesses cost at this shape."""
    r, s, e, k, f = (x.cpu().numpy() for x in (rows, starts, ends, keys, fresh))
    cells = [r[i].astype(np.int64) * cpg + np.unique((k[s[i]:e[i]] >> 1) & (cpg - 1))
             for i in range(len(s)) if e[i] > s[i] and not f[i]]
    idx = torch.from_numpy(np.concatenate(cells)).cuda()
    table = torch.arange(32768, dtype=torch.int16, device=idx.device).flip(0)
    return graph_ms(lambda: bank.index_put_((idx,), table[bank[idx].long()]))


def launch_floor_ms(ga):
    """Graph time of one launch of the empty kernel of csrc/empty.cu, or
    None for a package without it (an older checkout under
    tools/torch_kernel_times.py)."""
    lib = ga.kernels.library()
    if not hasattr(lib, "dliom_empty_launch"):
        return None
    return graph_ms(lambda: ga.kernels.check(
        lib.dliom_empty_launch(torch.cuda.current_stream().cuda_stream), "empty"))


def check_affine_chain(ac, rng):
    out = {}
    for batch, m in [(1, m) for m in K2_LENGTHS] + [(max(BATCHES), IMU_CAP)]:
        shape = (m, 15, 15) if batch == 1 else (batch, m, 15, 15)
        f = torch.from_numpy((np.eye(15) + 0.01 * rng.normal(size=shape)).astype(np.float32)).cuda()
        q = rng.normal(size=shape).astype(np.float32) * 1e-3
        q = torch.from_numpy(q @ np.swapaxes(q, -1, -2)).cuda()
        a_k, p_k = ac.affine_chain(f, q)
        a_p, p_p = ac.affine_chain_plain(f, q)
        torch.cuda.synchronize()
        torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(p_k, p_p, rtol=1e-5, atol=1e-6)
        err = float(max((a_k - a_p).abs().max(), (p_k - p_p).abs().max()))
        t = timings(lambda: ac.affine_chain(f, q), lambda: ac.affine_chain_plain(f, q))
        t["bound_ms"], t["bound_by"] = bound(*k2_work(batch, m))
        print(f"K2 affine_chain B={batch} M={m}: max abs err {err:.3e} (rtol 1e-5, atol 1e-6); {fmt_times(t)}")
        out[m if batch == 1 else f"B{batch}_M{m}"] = dict(t, max_abs_err=err)
    return out


def check_window_gn(dev):
    """Phase 4b: K3 (csrc/window_gn.cu) against `optimize_plain` on the card
    at tools/torch_window_gn_times.py's shapes (W = 4 at B = 1 and 18, the
    runner's W = 6), at 8 iterations and at 1: each of q, p, v, ba, bg
    within its bound (tests/window_cases.py, as the card tests hold it);
    the graph ms of both and the bound of K3's dependent chain."""
    import torch_window_gn_times as wgn
    from window_cases import out_of_bounds  # on the path the tool sets

    ns = wgn.chain_latency_ns()
    print("K3 chain: ns a dependent step " + ", ".join(f"{k} {v:.3f}" for k, v in ns.items()), flush=True)
    out = {"chain_latency_ns": ns}
    for w, b in wgn.SHAPES:
        m = wgn.measure(w, b, dev, ns)
        check(not out_of_bounds(m["gaps"]), f"K3 W={w} B={b}: {out_of_bounds(m['gaps'])}")
        gaps = ", ".join(f"{f} {g['gap']:.2e}/{g['step']:.2e}" for f, g in m["gaps"]["iterations_1"].items())
        print(f"K3 window_gn W={w} B={b}: gap/plain step at 1 iteration {gaps}; largest gap at 8 "
              f"{max(g['gap'] for g in m['gaps']['iterations_8'].values()):.3e}; graph ms "
              f"{m['k3_graph_ms']:.4f} (plain {m['plain_graph_ms']:.3f}, {m['plain_kernels']} kernels); "
              f"chain bound {m['chain_bound_ms']:.4f} ms over {m['chain_steps']} dependent steps; "
              f"{m['bytes']} B", flush=True)
        out[f"W{w}_B{b}"] = m
    return out


def bench_scans(device):
    """bench.py's ten scans (corkscrew poses, IMU recipe, seed 0), cycled,
    stamped 0.6 s apart."""
    from dliom_tpu_torch.frontend.lio import LioScanInput
    from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
    from dliom_tpu_torch.sensor.types import pad_point_cloud

    world = SyntheticWorld.create()
    rng = np.random.default_rng(0)
    base = []
    for _, pose in corkscrew_trajectory()[:10]:
        pts, times = world.cast_scan(pose)
        cloud = pad_point_cloud(pts, times, CAPACITY)
        accs = np.tile(np.array([0, 0, G], np.float32), (IMU_CAP, 1))
        accs += rng.normal(0, 0.01, accs.shape).astype(np.float32)
        gyrs = rng.normal(0, 0.002, (IMU_CAP, 3)).astype(np.float32)
        base.append((cloud, accs, gyrs))

    def scan(i):
        cloud, accs, gyrs = base[i % len(base)]
        host = dict(points=cloud.points, times=cloud.times, mask=cloud.mask,
                    imu_dts=np.full(IMU_CAP, 0.0025, np.float32), imu_acc=accs, imu_gyr=gyrs,
                    imu_mask=np.arange(IMU_CAP) < 40)
        return LioScanInput(time=torch.tensor(0.6 * (i + 1), dtype=torch.float32, device=device),
                            **{k: torch.from_numpy(v).to(device) for k, v in host.items()})
    return scan


def lane_scans(device, batch, n, n_points=CAPACITY, imu_cap=IMU_CAP, empty_first=()):
    """n steps of B-stacked scans: lane b on bench_scans' ten corkscrew
    poses, cycled, cast in its own world (offset b * LANE_OFFSET), with
    bench.py's IMU recipe, stamped 0.6 s apart; the lanes in `empty_first`
    see no points on the first step."""
    from dliom_tpu_torch.frontend.lio import LioScanInput
    from dliom_tpu_torch.io.synthetic import SyntheticWorld, corkscrew_trajectory
    from dliom_tpu_torch.sensor.types import pad_point_cloud
    from dliom_tpu_torch.transform.rigid import Rigid3

    world = SyntheticWorld.create()
    poses = [p for _, p in corkscrew_trajectory()[:10]]
    clouds = {}
    rng = np.random.default_rng(0)
    valid = imu_cap * 5 // 6  # 40 of bench.py's 48
    out = []
    for i in range(n):
        lanes = []
        for b in range(batch):
            key = (b, i % len(poses))
            if key not in clouds:
                pose = poses[key[1]]
                clouds[key] = pad_point_cloud(*world.cast_scan(Rigid3(
                    pose.rotation, pose.translation + b * LANE_OFFSET)), n_points)
            cloud = clouds[key]
            accs = np.tile(np.array([0, 0, G], np.float32), (imu_cap, 1))
            accs += rng.normal(0, 0.01, accs.shape).astype(np.float32)
            lanes.append(dict(
                time=np.float32(0.6 * (i + 1)), points=np.asarray(cloud.points),
                times=np.asarray(cloud.times),
                mask=np.asarray(cloud.mask) & (i > 0 or b not in empty_first),
                imu_dts=np.full(imu_cap, 0.0025, np.float32), imu_acc=accs,
                imu_gyr=rng.normal(0, 0.002, (imu_cap, 3)).astype(np.float32),
                imu_mask=np.arange(imu_cap) < valid))
        out.append(LioScanInput(**{k: torch.from_numpy(np.stack([x[k] for x in lanes])).to(device)
                                   for k in LioScanInput._fields}))
    return out


def fresh_state(cfg, device):
    from dliom_tpu_torch.frontend.lio import make_lio_state
    from dliom_tpu_torch.imu.preintegration import NavState

    zero = torch.zeros(3, device=device)
    return make_lio_state(cfg, NavState.identity(device), zero, zero)


def warm_profile(cycles, host=True):
    """torch.profiler over the last of `cycles` (callables run in turn): the
    first is a warm-up cycle, whose events are dropped (a profile without
    one lost device events at its start, PERF.md Findings, PR 3). With
    `host=False` only the card's activity is recorded: no host ops or
    spans, and the events take seconds, not tens, to read. Returns (the
    profiler, host ms of the recorded cycle)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host else []
    with profile(activities=activities + [ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=len(cycles) - 1, active=1, repeat=1)) as prof:
        for cycle in cycles:
            t0 = time.perf_counter()
            cycle()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            prof.step()
    return prof, wall


def profile_slice(cfg, state, inputs):
    """Phase 6, where the time goes: torch.profiler over a few more scans,
    after a warm-up cycle of as many. Per span of lio_step
    (record_function): host time, kernel time on the card and kernel count
    per scan, and the card's idle share of the wall time. The profiler's
    own overhead inflates the host times."""
    from dliom_tpu_torch.frontend.lio import run_lio_chunk

    n = len(inputs) // 2
    box = {"state": state}

    def cycle(chunk):
        def run():
            box["state"], _ = run_lio_chunk(box["state"], chunk, cfg)
        return run

    prof, wall = warm_profile([cycle(inputs[:n]), cycle(inputs[n:])])
    print_spans(prof.events(), n, wall / n, "profile")


def print_spans(events, n, wall, tag):
    """Per span of lio_step over `n` profiled scans of `wall` ms each: host
    time, kernel time on the card and kernel count per scan, and the
    card's idle share."""
    def kernels(ev):
        return list(ev.kernels) + [k for c in ev.cpu_children for k in kernels(c)]

    busy = sum(k.duration for ev in events for k in ev.kernels) / 1e3 / n
    count = sum(len(ev.kernels) for ev in events) / n
    print(f"{tag}: {n} scans, {wall:.1f} ms/scan wall under the profiler, kernels "
          f"{busy:.2f} ms/scan ({count:.0f} launches), card idle share {1 - busy / wall:.3f}")
    for name in SPANS:
        spans = [ev for ev in events if ev.name == name]
        check(spans, f"profiler saw span {name}")
        ks = [k for ev in spans for k in kernels(ev)]
        host = sum(ev.cpu_time_total for ev in spans) / 1e3 / n
        print(f"{tag}: {name:20s} host {host:8.2f} ms/scan  kernels "
              f"{sum(k.duration for k in ks) / 1e3 / n:7.3f} ms/scan  "
              f"{len(ks) / n:8.0f} launches/scan")


def check_slice(ga, ac, dev):
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.frontend.lio import run_lio_chunk

    cfg = load_config("basic", BENCH_OVERRIDES).override(
        {"trajectory_builder": {"submaps": SPAWN_CAPACITIES}}).trajectory_builder
    scan = bench_scans(dev)
    inputs = [scan(i) for i in range(WARMUP + TIMED + 2 * PROFILED)]  # cast before timing
    torch.cuda.reset_peak_memory_stats()
    state, results = run_lio_chunk(fresh_state(cfg, dev), inputs[:WARMUP], cfg)
    torch.cuda.synchronize()
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.LAUNCHES = 0  # the timed run starts: zero the launch counts
    ac.LAUNCHES = wo.LAUNCHES = 0
    t0 = time.perf_counter()
    state, timed = run_lio_chunk(state, inputs[WARMUP:WARMUP + TIMED], cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"grouped_apply": ga.LAUNCHES, "affine_chain": ac.LAUNCHES}
    K3_BY_PATH["slice"] = wo.LAUNCHES
    results += timed
    scans_per_s = TIMED / wall
    inserted = sum(bool(r.scan.inserted) for r in timed)
    sm = state.frontend.submaps
    drops = {"brick": int(sm.high_brick.dropped[0]), "low_brick": int(sm.low_brick.dropped[0]),
             "dense": int(sm.dense_dropped[0])}
    print(f"slice: {TIMED} timed scans in {wall:.3f} s = {scans_per_s:.2f} scans/s; "
          f"{inserted} inserted; submaps created {int(sm.num_created)}; drops {drops}; "
          f"launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    for k, r in enumerate(results):
        check(bool(torch.isfinite(r.scan.local_pose.translation).all()
                   and torch.isfinite(r.scan.local_pose.rotation).all()), f"scan {k} pose finite")
        check(not bool(r.failed), f"scan {k} failed")
    check(int(state.failures) == 0, "no failure resets")
    check(not any(drops.values()), f"no dropped grid updates {drops}")
    check(int(sm.num_created) >= 2, "crossed a submap spawn")
    check(launches["grouped_apply"] >= 2 * inserted and launches["grouped_apply"] > 0,
          "K1 launched for both brick banks on every inserted scan")
    check(launches["affine_chain"] >= TIMED, "K2 launched on every scan")
    check(K3_BY_PATH["slice"] == TIMED,
          f"slice: K3 {K3_BY_PATH['slice']} launches for {TIMED} steps")

    t_prof = time.perf_counter()
    profile_slice(cfg, state, inputs[WARMUP + TIMED:])
    t_cpu = time.perf_counter()

    # the first scans against the port's CPU run, where K1/K2 run plain
    cpu, cpu_scan = torch.device("cpu"), bench_scans(torch.device("cpu"))
    _, cpu_results = run_lio_chunk(fresh_state(cfg, cpu), [cpu_scan(i) for i in range(COMPARE)], cfg)
    worst = 0.0
    for k in range(COMPARE):
        g, c = results[k].scan.local_pose, cpu_results[k].scan.local_pose
        d = max(float((g.translation.cpu() - c.translation).abs().max()),
                float((g.rotation.cpu() - c.rotation).abs().max()))
        worst = max(worst, d)
        check(d <= POSE_ATOL, f"scan {k}: CUDA vs CPU pose differ by {d:.3e} > {POSE_ATOL}")
        check(bool(results[k].scan.inserted) == bool(cpu_results[k].scan.inserted), f"scan {k} inserted")
    print(f"slice: first {COMPARE} scans CUDA vs CPU: largest pose difference {worst:.3e} "
          f"(tolerance {POSE_ATOL}); seconds: the profile {t_cpu - t_prof:.1f}, the CPU run "
          f"{time.perf_counter() - t_cpu:.1f}")
    spawn = next(k for k, r in enumerate(results) if int(r.scan.insertion_submap_ids[1]) == 1)
    return launches, scans_per_s, spawn


def check_compiled(ga, ac, dev, eager_rate, eager_launches, spawn):
    """Phase 14, after phases 5-6: the compiled step (`make_jit_lio_step`,
    `make_jit_lio_chunk`) at phase 5's bench config, full width. (a) the
    warm-up (the first step, eager) and the capture and instantiation of
    its graph, timed; (b) at scans 1, 2 and `spawn` (phase 5's first
    scan of the second submap), the eager `lio_step` and one graph replay,
    each from a copy of the same pre-step state (the graph's copied into
    its buffers): the integer map state bit for bit, the largest pose and
    velocity differences printed (expected 0), the pose within POSE_ATOL;
    (c) scans/s over phase 5's TIMED scans for the compiled step (after
    WARMUP replays from a fresh state, copied into the same graph) beside
    phase 5's eager rate, its K1 and K2 launches counted through the
    replays against phase 5's, and the compiled chunk at bench.py's CHUNK
    over the first CHUNK x (TIMED // CHUNK) of them; the card's idle share
    over replays of each (torch.profiler, the card's activity only)."""
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.frontend.lio import LioScanInput, lio_step, make_jit_lio_chunk, make_jit_lio_step

    cfg = load_config("basic", BENCH_OVERRIDES).override(
        {"trajectory_builder": {"submaps": SPAWN_CAPACITIES}}).trajectory_builder
    scan = bench_scans(dev)
    inputs = [scan(i) for i in range(WARMUP + TIMED)]
    step = make_jit_lio_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(fresh_state(cfg, dev), inputs[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    tallies = {k: v for k, v in step.counts().items() if k != "marks"}
    check(tallies == {"steps": 1, "warmups": 1, "captures": 1, "replays": 0}, f"compiled: {tallies}")
    print(f"compiled: the first step (the eager warm-up, then the capture) in {first_s:.2f} s, of which "
          f"capture and instantiation {step.capture_seconds} s; a replay launches {step.launches}",
          flush=True)

    held = {}
    for k in range(1, spawn + 1):
        if k not in (1, 2, spawn):
            step(step.state, inputs[k])
            continue
        pre = tree_clone(step.state)
        eager = without_launches(lambda: lio_step(tree_clone(pre), inputs[k], cfg))
        state, res = step(pre, inputs[k])  # the pre-step copy goes into the graph's buffers
        held[k] = graph_vs_eager((state, res), eager)
        created = (int(pre.frontend.submaps.num_created), int(state.frontend.submaps.num_created))
        held[k]["num_created"] = created
    check(held[spawn]["num_created"] == (1, 2), f"compiled: scan {spawn} spawns the second submap "
          f"({held[spawn]['num_created']})")
    compare = check_held("compiled", held)

    def profiled(run):
        prof, wall = warm_profile([run, run], host=False)
        busy, _ = card_busy_ms(prof.events())
        return None if busy == 0 else 1 - busy / wall

    # (c) the compiled step over phase 5's timed scans, from a fresh state
    step(fresh_state(cfg, dev), inputs[0])
    step(step.state, inputs[1])
    after_warmup = tree_clone(step.state)
    torch.cuda.synchronize()
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.LAUNCHES = ac.LAUNCHES = wo.LAUNCHES = 0
    t0 = time.perf_counter()
    for inp in inputs[WARMUP:]:
        step(step.state, inp)
    torch.cuda.synchronize()
    step_rate = TIMED / (time.perf_counter() - t0)
    launches = {"grouped_apply": ga.LAUNCHES, "affine_chain": ac.LAUNCHES}
    K3_BY_PATH["compiled"] = wo.LAUNCHES
    check(launches == eager_launches, f"compiled: launches over the replays {launches}, eager {eager_launches}")
    check(K3_BY_PATH["compiled"] == TIMED,
          f"compiled: K3 {K3_BY_PATH['compiled']} launches for {TIMED} steps")
    sm = step.state.frontend.submaps
    drops = int(sm.high_brick.dropped[0]) + int(sm.low_brick.dropped[0])
    check(drops == 0 and int(step.state.failures) == 0 and int(sm.num_created) >= 2,
          f"compiled: drops {drops}, failures {int(step.state.failures)}, submaps {int(sm.num_created)}")
    check(bool(torch.isfinite(step.result.scan.local_pose.translation).all()), "compiled: last pose finite")
    step_idle = profiled(lambda: [step(step.state, inp) for inp in inputs[WARMUP:WARMUP + 5]])

    chunks = [LioScanInput(*(torch.stack(x) for x in zip(*inputs[a:a + CHUNK])))
              for a in range(WARMUP, WARMUP + TIMED - CHUNK + 1, CHUNK)]
    chunk = make_jit_lio_chunk(cfg, CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk(tree_clone(after_warmup), chunks[0])
    torch.cuda.synchronize()
    chunk_first_s = time.perf_counter() - t0
    chunk.load_state(after_warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in chunks:
        chunk(chunk.state, c)
    torch.cuda.synchronize()
    chunk_rate = CHUNK * len(chunks) / (time.perf_counter() - t0)
    check(bool(torch.isfinite(chunk.result.scan.local_pose.translation).all()), "compiled: chunk poses finite")
    chunk_idle = profiled(lambda: chunk(chunk.state, chunks[0]))
    exit_cost = {d: lm_exit_cost(cfg, after_warmup, inputs[WARMUP:WARMUP + EXIT_SCANS], d)
                 for d in (dev, torch.device("cpu"))}
    fmt = lambda x: "not measured (the profiler saw no kernels)" if x is None else f"{x:.3f}"  # noqa: E731
    print(f"compiled: scans/s over the {TIMED} timed scans: lio_step (eager, phase 5) {eager_rate:.3f}, "
          f"make_jit_lio_step {step_rate:.3f} (card idle share over 5 replays {fmt(step_idle)}); "
          f"make_jit_lio_chunk at CHUNK {CHUNK} over {CHUNK * len(chunks)} of them {chunk_rate:.3f} (its first "
          f"call, {CHUNK} eager steps and the capture, {chunk_first_s:.2f} s, capture and instantiation "
          f"{chunk.capture_seconds} s; idle share over a replay {fmt(chunk_idle)}); launches over the "
          f"replays {launches} = phase 5's eager run", flush=True)
    for d, c in exit_cost.items():
        print(f"compiled: the eager lio_step on the {d.type} over {EXIT_SCANS} scans, LM early exit "
              f"{c['early_exit_ms']:.1f} ms/scan ({c['iterations']:.2f} iterations on average), fixed trip of "
              f"{cfg.ceres_scan_matcher.max_num_iterations} {c['fixed_trip_ms']:.1f} ms/scan; poses equal: "
              f"{c['equal']}", flush=True)
        check(c["equal"], f"compiled: on the {d.type} the fixed-trip LM's poses differ from the early exit's")
    marks = {"step": step.counts()["marks"], "chunk": chunk.counts()["marks"]}
    print(f"compiled: stage marks, medians over the replays (common/stages.py): {json.dumps(marks)}", flush=True)
    lm = lm_departure(cfg, after_warmup, inputs[WARMUP:WARMUP + EXIT_SCANS], dev)
    return launches, {"first_step_s": first_s, "stage_marks": marks, "capture_s": step.capture_seconds, "graph_vs_eager": compare,
                      "lm_exit_cost": {d.type: c for d, c in exit_cost.items()}, "lm_departure": lm,
                      "eager_scans_per_s": eager_rate, "step_scans_per_s": step_rate, "step_idle_share": step_idle,
                      "chunk": CHUNK, "chunk_scans_per_s": chunk_rate, "chunk_first_s": chunk_first_s,
                      "chunk_capture_s": chunk.capture_seconds, "chunk_idle_share": chunk_idle}


def lm_departure(cfg, state, inputs, dev):
    """Phase 14, beside `lm_exit_cost`: the eager `lio_step` on the card over
    the same scans from the same state; at each scan's match,
    tools/torch_lm_trace.py traces the LM on the card (under cuSOLVER, as
    the graph) and on the CPU from copies of the same arguments, each trace
    equal to its device's own `match`. Prints the first quantity that
    departs beyond the tool's BOUNDS, the largest difference of each, both
    devices' iterations and the convergence ratio closest to the
    tolerance. Fails if a quantity departs, or if the iterations differ
    anywhere but at the threshold (both ratios within BOUNDS["ratio"] of
    the tolerance, where rounding alone can flip the exit)."""
    import torch_lm_trace as tl

    tol = cfg.ceres_scan_matcher.function_tolerance
    t0 = time.perf_counter()
    traces = without_launches(lambda: tl.chain_traces(
        cfg, state, inputs, {"cpu": (torch.device("cpu"), None), "cuda": (dev, "cusolver")}))
    c = tl.compare(traces, "cpu", "cuda", tol)
    worst = {k: max(v) for k, v in c["worst_by_iteration"].items()}
    closest = min(abs(r["ratio"] - tol) for scan in traces for t in scan.values() for r in t["rows"])
    print(f"compiled: the LM on the card against the CPU from the same match arguments over {len(traces)} "
          f"scans (tools/torch_lm_trace.py): first quantity beyond its bound {c['first_departure']}; largest "
          f"differences " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f"; iterations {c['iterations']}; "
          f"the convergence ratio closest to the tolerance {tol} lies {closest:.2e} from it; flips "
          f"{c['iteration_flips']}; {time.perf_counter() - t0:.1f} s", flush=True)
    check(all(t["equal_to_match"] and t["replayed"] for scan in traces for t in scan.values()),
          "compiled: an LM trace ends where its device's match does")
    check(c["first_departure"] is None, f"compiled: the card's LM departs from the CPU's: {c['first_departure']}")
    check(all(f["at_threshold"] for f in c["iteration_flips"]),
          f"compiled: the card's LM exits apart from the CPU's away from the threshold: {c['iteration_flips']}")
    return {"first_departure": c["first_departure"], "worst": worst, "iterations": c["iterations"],
            "closest_ratio_to_tolerance": closest, "flips": c["iteration_flips"]}


def lm_exit_cost(cfg, state, inputs, device):
    """The eager `lio_step` over `inputs` from `state` on `device`, with its
    LM's fixed trip and with the early exit (`match(host_exit=True)`, a
    host read per iteration), in the order early, fixed, fixed, early: ms
    per scan of each (the mean of its two runs), the early exit's mean
    iterations, and whether both forms give the same poses bit for bit."""
    import functools

    from dliom_tpu_torch.frontend import local_trajectory_builder as ltb
    from dliom_tpu_torch.frontend.lio import lio_step

    state, inputs = tree_clone(state), [tree_clone(x) for x in inputs]
    if device.type == "cpu":
        state, inputs = tree_cpu(state), [tree_cpu(x) for x in inputs]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ms, poses, iters = {True: [], False: []}, {}, []

    def run(host_exit):
        s, out, match = tree_clone(state), [], ltb.match
        ltb.match = functools.partial(match, host_exit=host_exit)
        try:
            sync()
            t0 = time.perf_counter()
            for inp in inputs:
                s, res = lio_step(s, inp, cfg)
                out.append(res)
            sync()
        finally:
            ltb.match = match
        ms[host_exit].append(1e3 * (time.perf_counter() - t0) / len(inputs))
        poses[host_exit] = [torch.cat([r.scan.local_pose.rotation, r.scan.local_pose.translation]) for r in out]
        if host_exit:
            iters[:] = [int(r.scan.matcher_iterations) for r in out]

    for host_exit in (True, False, False, True):
        without_launches(lambda: run(host_exit))
    return {"early_exit_ms": float(np.mean(ms[True])), "fixed_trip_ms": float(np.mean(ms[False])),
            "iterations": float(np.mean(iters)),
            "equal": all(torch.equal(a, b) for a, b in zip(poses[True], poses[False]))}


def dense_keys(ga, rng, groups, num_records, cpg, cells=None):
    """One insert's sorted packed keys over the bank groups `groups`, each
    touched at least once, with duplicate cells (4 apart, or only `cells`
    distinct ones), mixed hit/miss and 5% sentinel records."""
    group = np.asarray(groups, np.int32)[rng.integers(0, len(groups), num_records)]
    group[:len(groups)] = groups
    cell = rng.integers(0, cpg // 4, num_records) * 4 if cells is None else rng.integers(0, cells, num_records)
    valid = rng.random(num_records) < 0.95
    valid[:len(groups)] = True
    keys = ga.pack_keys(torch.from_numpy(group), torch.from_numpy(cell.astype(np.int32)),
                        torch.from_numpy(rng.integers(0, 2, num_records).astype(np.int32)),
                        torch.from_numpy(valid), cpg)
    return torch.sort(keys).values.cuda()


def check_dense_grouped_apply(ga, rng):
    """Phase 7: K1's dense entry at bench_e2e's dense banks, one insert's
    49152 records: the high bank (2 x 128^3 cells plus the padding group =
    257 groups of 16384) with all 256 steps used, with 100 groups touched
    (156 steps park on the padding group) and with 200 touched at capacity
    64 (136 dropped); the low bank (2 x 64^3 plus padding = 33 groups) at
    256 steps, where 224 steps park, as on every insert of phase 8; then the
    edge cases on the high bank. Returns the timed cases (the first with
    its device time per kernel per call) and the device kernels of one
    call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    cpg = ga.DENSE_CELLS_PER_GROUP
    cases = [  # tag, extent, capacity, touched groups, records, distinct cells, timed
        ("dense", 128, 256, range(256), 49152, None, True),
        ("dense_park", 128, 256, range(100), 49152, None, True),
        ("dense_overflow", 128, 64, range(200), 49152, None, True),
        ("dense_low", 64, 256, range(32), 49152, None, True),
        ("all_sentinel", 128, 256, [], 49152, None, False),
        ("one_group", 128, 256, [17], 49152, None, False),
        ("exact_capacity", 128, 64, range(0, 256, 4), 49152, None, False),
        ("capacity_plus_one", 128, 64, range(0, 260, 4), 49152, None, False),
        ("last_real_group", 128, 256, [3, 254, 255], 49152, None, False),
        ("duplicate_heavy", 128, 256, [9, 10], 3000, 12, False),
        ("long_runs", 128, 256, [5, 6], 3000, 2, False),  # runs of ~750 across the kernel's tiles
    ]
    out, kernels_per_call = {}, None
    for tag, extent, capacity, touched, records, cells, timed in cases:
        touched = list(touched)
        groups = 2 * extent ** 3 // cpg + 1
        kw = dict(cells_per_group=cpg, hit_odds=0.55 / 0.45, miss_odds=0.49 / 0.51,
                  dummy_group=groups - 1, num_groups=capacity)
        bank = torch.from_numpy(rng.integers(0, 32768, groups * cpg).astype(np.int16)).cuda()
        if touched:
            keys = dense_keys(ga, rng, touched, records, cpg, cells)
        else:
            keys = torch.full((records,), 2**31 - 1, dtype=torch.int32).cuda()
        k, kd = ga.apply_grouped_updates(bank.clone(), keys, **kw)
        p, pd = ga.apply_grouped_updates_plain(bank.clone(), keys, **kw)
        torch.cuda.synchronize()
        err = int((k.int() - p.int()).abs().max())
        check(torch.equal(k, p), f"K1 {tag}: kernel bank differs from plain ({err})")
        check(int(kd) == int(pd) == max(0, len(touched) - capacity),
              f"K1 {tag}: dropped {int(kd)} (kernel) vs {int(pd)} (plain)")
        check(torch.equal(k[-cpg:], bank[-cpg:]), f"K1 {tag}: padding group changed")
        check(torch.equal(k, bank) == (not touched), f"K1 {tag}: the bank changed where it should")
        line = (f"K1 apply_grouped_updates {tag}: {groups} groups, {capacity} steps, "
                f"{len(touched)} touched, {max(0, capacity - len(touched))} parked, dropped {int(kd)}: "
                f"bit-identical, padding group unchanged")
        if not timed:
            print(line)
            continue
        work = bank.clone()
        if kernels_per_call is None:
            # one warm-up cycle, then one recorded cycle: after phase 6's
            # profile, a profile without a warm-up lost the device events
            # at its start (it saw none of one call's two kernels)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                          repeat=1)) as prof:
                for _ in range(2):
                    for _ in range(PROFILED_CALLS):
                        ga.apply_grouped_updates(work, keys, **kw)
                    torch.cuda.synchronize()
                    prof.step()
            device = device_events(prof.events())
            kernels_per_call = len(device) / PROFILED_CALLS
            split = {}
            for e in device:
                split[e.name] = split.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / PROFILED_CALLS
            line += (f"; {kernels_per_call:g} device kernels per call: "
                     + ", ".join(f"{name} {ms:.4f} ms" for name, ms in split.items()))
        t = timings(lambda: ga.apply_grouped_updates(work, keys, **kw),
                    lambda: ga.apply_grouped_updates_plain(work, keys, **kw))
        t["bound_ms"], t["bound_by"] = bound(k1_dense_bytes(keys, capacity, cpg, ga.cell_bits(cpg)))
        print(f"{line}; {fmt_times(t)}")
        out[tag] = dict(t, max_abs_err=err)
        if tag == "dense":
            out[tag]["device_split_ms"] = split
    return out, kernels_per_call


def e2e_course(n_scans, poses=False, radius=None):
    """bench.py's bench_e2e feed, which is tools/torch_e2e_loop_ate.py's
    course, made up front: per scan its IMU samples [(t, acc, gyr)], its
    stamp, points and point times, and with `poses` the true pose. The
    first E2E_STATIC scans stand still; then the circle at 1.5 m/s, of 5 m
    unless `radius` is given."""
    from torch_e2e_loop_ate import N_REST, RADIUS, course

    check(N_REST == E2E_STATIC, "the e2e course's static scans")
    return [c if poses else c[:4] for c in course(n_scans, radius=radius or RADIUS)]


def e2e_accuracy(pg, course):
    """tools/torch_e2e_loop_ate.py's `evaluate` of `pg` on the e2e course,
    the truth paired with the nodes by node time: under pipeline_depth 1 a
    node lags its scan, so the tool's own pairing (the truth of each scan
    after which the node count went up) does not hold."""
    from torch_e2e_loop_ate import evaluate, ground_truth_by_time

    out = evaluate(pg, ground_truth_by_time(pg, [c[1] for c in course], [c[4].translation for c in course]))
    check(np.isfinite(out["ate_rmse_m"]) and np.isfinite(out["endpoint_err_m"]), f"e2e evaluator finite: {out}")
    return out


def fmt_accuracy(a):
    return (f"ATE {a['ate_rmse_m']:.4f} m, endpoint error {a['endpoint_err_m']:.4f} m, INTER {a['num_inter']}, "
            f"nodes {a['num_nodes']}, submaps {a['num_submaps']}")


def drive(builder, scans):
    for imu, t, pts, ptimes, *_ in scans:
        for ti, acc, gyr in imu:
            builder.add_imu_data(ti, acc, gyr)
        builder.add_range_data(t, pts, ptimes)


def card_busy_ms(events):
    """Union of the device-side intervals (ms) the profiler saw, over all
    streams (overlapping kernels of two streams count once), and the five
    device activities with the most time (name, ms, count). The profiler
    also projects each record_function span onto the device timeline; those
    annotations are left out, so only kernels, copies and sets count."""
    from collections import Counter

    device = device_events(events)
    ms, count = Counter(), Counter()
    for e in device:
        ms[e.name] += e.time_range.elapsed_us() / 1e3
        count[e.name] += 1
    top = [(name, t, count[name]) for name, t in ms.most_common(5)]
    busy, end = 0.0, -1.0
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, top


def tree_clone(tree):
    """Copies of a tree's tensors on their device."""
    from torch.utils._pytree import tree_map

    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def tree_cpu(tree):
    from torch.utils._pytree import tree_map

    return tree_map(lambda x: x.to("cpu", copy=True) if isinstance(x, torch.Tensor) else x, tree)


def without_launches(fn):
    """fn() with the kernel launch counters left as they were (the launches
    of a comparison are not the main path's), under the compiled step's
    linear algebra (`common/graph.py::cusolver`), so an eager step takes
    the routines its graph replays."""
    from dliom_tpu_torch.common import graph as cg

    before = cg.launch_counts()
    try:
        with cg.cusolver():
            return fn()
    finally:
        cg.add_launches({k: before[k] - v for k, v in cg.launch_counts().items()})


def graph_vs_eager(graph, eager):
    """A compiled step's (state, result) against the eager step's from the
    same pre-step state and input: the integer leaves that differ (state
    and result flags), the float state leaves that differ with their
    largest difference (relative to the eager leaf's largest magnitude
    where that is over 1), and the largest local pose and velocity
    differences."""
    from dliom_tpu_torch.io.serialization import state_leaves

    ints, floats = [], {}
    for (path, x), (_, y) in zip(state_leaves(graph[0]), state_leaves(eager[0])):
        if not torch.equal(x, y):
            if x.dtype.is_floating_point:
                floats[path] = float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
            else:
                ints.append(path)
    g, e = graph[1], eager[1]
    for f in ("inserted", "finished_submap", "matcher_iterations", "num_hits", "insertion_submap_ids"):
        if not torch.equal(getattr(g.scan, f), getattr(e.scan, f)):
            ints.append("result." + f)
    pose = max(float((g.scan.local_pose.translation - e.scan.local_pose.translation).abs().max()),
               float((g.scan.local_pose.rotation - e.scan.local_pose.rotation).abs().max()))
    return {"int_differ": ints, "float_differ": floats, "pose": pose,
            "velocity": float((g.velocity - e.velocity).abs().max())}


def check_held(tag, held):
    """Every held step's integer state bit for bit, its pose within
    POSE_ATOL and its velocity and float state within HELD_ATOL of the
    eager step's; prints the largest differences and names any float state
    that differs (expected: none)."""
    check(held, f"{tag}: steps held against the eager step")
    for k, h in held.items():
        check(not h["int_differ"], f"{tag} step {k}: graph vs eager integer state differs: {h['int_differ']}")
        check(h["pose"] <= POSE_ATOL, f"{tag} step {k}: graph vs eager pose differ by {h['pose']:.3e}")
        check(h["velocity"] <= HELD_ATOL, f"{tag} step {k}: graph vs eager velocity differ by {h['velocity']:.3e}")
        far = {p: d for p, d in h["float_differ"].items() if not d <= HELD_ATOL}
        check(not far, f"{tag} step {k}: graph vs eager float state differs beyond {HELD_ATOL}: {far}")
    floats = sorted({p for h in held.values() for p in h["float_differ"]})
    pose, vel = max(h["pose"] for h in held.values()), max(h["velocity"] for h in held.values())
    print(f"{tag}: {len(held)} steps (graph replay or warm-up) against the eager step from the same "
          f"pre-step state on the card: integer state bit for bit; largest pose difference {pose:.3e}, "
          f"velocity {vel:.3e}; float state leaves that differ: {floats or 'none'}", flush=True)
    return {"steps": len(held), "pose_diff": pose, "velocity_diff": vel, "float_differ": floats}


def hold_steps(select=lambda k, rec: False, keep=lambda k, rec: False, after=None):
    """Wrap MapBuilder's per-scan step (`_TrajectoryBuilder._lio_step`, the
    compiled step on the card); returns the dict it fills. Step k with
    `keep(k, rec)`: a CPU copy of the pre-step state (the graph's buffers,
    copied before the replay) and input, for a re-run on the CPU. Step k
    with `select(k, rec)`: a copy of the pre-step state and the input stay
    on the card, and after the step the eager `lio_step` runs from them with
    rec["eager"] set, so the per-call recorders of the caller hold its K1
    and brick calls against plain or the CPU (the wrappers do not run in a
    replay); then `graph_vs_eager` into rec["held"][k]. The eager re-run's
    launches are taken off the counters. `after(k, state, result, rec)`
    runs after each step. Also keeps each step's gravity_valid."""
    from dliom_tpu_torch import map_builder
    from dliom_tpu_torch.frontend.lio import LioScanInput, lio_step

    cls = map_builder._TrajectoryBuilder
    orig = cls._lio_step
    rec = {"n": 0, "held": {}, "steps": {}, "eager": False, "gravity_valid": []}

    def wrapped(self, arrays):
        k = rec["n"]
        hold, kept = select(k, rec), keep(k, rec)
        if hold or kept:
            inp = LioScanInput(*(torch.from_numpy(np.asarray(a)).to(self.device) for a in arrays))
        if kept:
            rec["steps"][k] = tree_cpu((self._lio, inp))
        pre = tree_clone(self._lio) if hold else None
        state, res = orig(self, arrays)
        rec["gravity_valid"].append(res.gravity_valid.clone())
        if hold:
            def eager():
                rec["eager"] = True
                try:
                    return lio_step(pre, inp, self.tb)
                finally:
                    rec["eager"] = False
            rec["held"][k] = graph_vs_eager((state, res), without_launches(eager))
        if after is not None:
            after(k, state, res, rec)
        rec["n"] = k + 1
        return state, res

    cls._lio_step = wrapped
    rec["restore"] = lambda: setattr(cls, "_lio_step", orig)
    return rec


BACKEND_GRAPHS = ("decompress", "project", "propose", "search_initial", "search_full", "spa_rows", "spa_jtj",
                  "spa_start", "spa_cg", "spa", "ndt")
HELD_REPLAYS = 2  # replays of each backend graph held against the eager body from the same inputs


def _leaf_diff(x, y):
    """(integers and flags equal, largest float difference) of two leaves;
    equal infinities (an unfound search's score) count as no difference."""
    if not x.dtype.is_floating_point:
        return torch.equal(x, y), 0.0
    same = (x == y) | (torch.isnan(x) & torch.isnan(y))
    d = torch.where(same, 0.0, (x - y).abs())
    return True, float(d.max()) if d.numel() else 0.0


def hold_backend_graphs(names=BACKEND_GRAPHS, replays=HELD_REPLAYS):
    """Wrap `StepGraph._step` (which `step()` and a call both run) so that
    the first `replays` replays of every graph named in `names` (the
    backend's programs, the NDT odometry) are held against the graph's
    body run eagerly, on the same thread and
    stream, from copies of the same static state and input (under the
    graph's linear algebra, `graph.cusolver`): integers and flags exactly
    (a search's `found`), floats within HELD_ATOL (score, pose; the SPA's
    poses; the NDT pose). Each held replay and its eager run are timed with
    their stream synchronized either side. Returns the dict it fills
    (`check_backend_held` reads it); rec["restore"]() unwraps."""
    import threading

    from torch.utils._pytree import tree_leaves

    from dliom_tpu_torch.common import graph as cg

    orig = cg.StepGraph._step
    rec = {"held": {}, "errors": [], "lock": threading.Lock()}

    def step(self, entry_ns):
        held = rec["held"].setdefault(id(self), {"name": self.name, "replays": 0, "int_equal": True,
                                                 "max_diff": 0.0, "replay_s": 0.0, "eager_s": 0.0})
        if (self.name not in names or self.graph is None or self.device.type != "cuda"
                or held["replays"] >= replays):
            return orig(self, entry_ns)
        try:
            stream = torch.cuda.current_stream(self.device)
            pre = tree_clone((self.state, self.inp))
            stream.synchronize()
            t0 = time.perf_counter()
            orig(self, entry_ns)
            stream.synchronize()
            t1 = time.perf_counter()
            with cg.cusolver():
                want_state, want = self.body(*pre)
            stream.synchronize()
            t2 = time.perf_counter()
            got = tree_leaves((self.state, self.result))
            for x, y in zip(got, tree_leaves((want_state, want))):
                if x is None:  # a body without a result
                    continue
                eq, d = _leaf_diff(x, y)
                held["int_equal"] &= eq
                held["max_diff"] = max(held["max_diff"], d)
            held["replays"] += 1
            held["replay_s"] += t1 - t0
            held["eager_s"] += t2 - t1
        except BaseException as e:  # a pool task's error: checked on the main thread
            with rec["lock"]:
                rec["errors"].append(f"{self.name}: {e!r}")
            raise

    cg.StepGraph._step = step
    rec["restore"] = lambda: setattr(cg.StepGraph, "_step", orig)
    return rec


def check_backend_held(tag, rec, required):
    """The held replays of `hold_backend_graphs`: no error, every graph
    named in `required` held at least once, integers exact and floats
    within HELD_ATOL; prints the largest difference and the replay and
    eager seconds per program. Returns them by program."""
    check(not rec["errors"], f"{tag}: holding the backend graphs failed: {rec['errors']}")
    by = {}
    for h in rec["held"].values():
        if not h["replays"]:
            continue
        b = by.setdefault(h["name"], {"graphs": 0, "replays": 0, "int_equal": True, "max_diff": 0.0,
                                      "replay_s": 0.0, "eager_s": 0.0})
        b["graphs"] += 1
        for k in ("replays", "replay_s", "eager_s"):
            b[k] += h[k]
        b["int_equal"] &= h["int_equal"]
        b["max_diff"] = max(b["max_diff"], h["max_diff"])
    for name in required:
        check(name in by, f"{tag}: no replay of a {name} graph was held against its eager run")
    for name, b in sorted(by.items()):
        check(b["int_equal"] and b["max_diff"] <= HELD_ATOL,
              f"{tag}: {name} graph replays vs eager: {b}")
        print(f"{tag}: {name}: {b['replays']} replays of {b['graphs']} graphs held against the eager body "
              f"from the same inputs: integers and flags equal, largest float difference {b['max_diff']:.3e}; "
              f"{b['replay_s'] / b['replays'] * 1e3:.2f} ms a replay against {b['eager_s'] / b['replays'] * 1e3:.2f} "
              f"ms eager (stream synchronized, host clock)", flush=True)
    return by


def replay_ms(graph, n=5):
    """Device ms of one replay of `graph` (CUDA events around n replays on
    the current stream, after one), and the device kernels of one replay
    (torch.profiler, the card's activity only)."""
    from torch.profiler import ProfilerActivity, profile

    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / n, len(device_events(prof.events()))


def measure_backend_graphs(pg):
    """After the pool threads are idle: per backend graph of `pg`'s programs,
    its capture seconds, its replay's device ms and kernels (`replay_ms`),
    and the device ms of copying a cached submap's grids into a thread's
    static grids. Replays run on this thread's stream from the static
    inputs the graph holds; nothing reads their results."""
    out = {}
    for name, gs in sorted(pg.programs().items()):
        for key, g in gs:
            if g.graph is None:
                continue
            ms, kernels = replay_ms(g.graph)
            shape = [list(x) for x in key[1:] if isinstance(x, tuple)]
            out.setdefault(name, []).append({"capture_s": g.capture_seconds, "replay_ms": ms,
                                             "kernels": kernels, "shapes": shape[:1], "counts": g.counts()})
    copy_ms = None
    progs = [p for p in pg._programs_by_thread.values() if p.grids is not None]
    if progs and pg._grid_cache:
        prog, hit = progs[0], next(iter(pg._grid_cache.values()))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            prog.loaded = None
            prog.load_grids(hit)
        end.record()
        torch.cuda.synchronize()
        copy_ms = start.elapsed_time(end) / 5
    for name, rows in sorted(out.items()):
        for r in rows:
            print(f"backend graph {name} {r['shapes']}: capture {r['capture_s']:.3f} s, replay "
                  f"{r['replay_ms']:.3f} ms device time, {r['kernels']} kernels; {r['counts']}", flush=True)
    print(f"backend: a cached submap's grids copied into a thread's static grids: {copy_ms} ms device time",
          flush=True)
    return {"graphs": out, "grid_copy_ms": copy_ms}


def check_graph_counts(tag, counts, stepped, trajectories=1):
    """The compiled steps' counts (`MapBuilder.step_counts()`, or summed over
    graphs): one warm-up and one capture per trajectory, every other
    stepped scan a replay."""
    print(f"{tag}: compiled step: {counts['steps']} steps = {counts['warmups']} warm-up + "
          f"{counts['replays']} replays; {counts['captures']} captures", flush=True)
    check(counts["steps"] == stepped and counts["warmups"] == counts["captures"] == trajectories
          and counts["replays"] == stepped - trajectories,
          f"{tag}: {counts} for {stepped} stepped scans over {trajectories} trajectories")
    return counts


def record_steps(pose_steps, bank_from, bank_max):
    """Make MapBuilder record what phase 8 holds against the CPU; returns
    the dict it fills (`hold_steps`'). CPU copies of the pre-step state and
    input of the steps in `pose_steps` and of every step of the bank
    window. The bank window starts at step `bank_from` and ends one step
    after the first step in it that finishes a submap (so it holds the next
    step's slot recycle), after at most `bank_max` steps. Every step of it
    is held against the eager step from the same pre-step state
    (`hold_steps`), and every call of K1's dense entry in that eager step
    against its plain version on a CPU copy of the same bank and keys at
    once, bit for bit, `dropped` included: graph = eager, eager kernel =
    plain."""
    from dliom_tpu_torch.ops import grouped_apply as ga

    dense = ga.apply_grouped_updates

    def window(k, rec):
        return bank_from <= k < rec.setdefault("end", bank_from + bank_max)

    def after(k, state, res, rec):
        if window(k, rec) and int(res.scan.finished_submap) >= 0:
            rec.setdefault("finished", []).append(k)
            rec["end"] = min(rec["end"], k + 2)

    rec = hold_steps(window, lambda k, rec: k in pose_steps or window(k, rec), after)
    rec.update(finished=[], calls=[], end=bank_from + bank_max)

    def dense_recording(pool, keys, **kw):
        if not rec["eager"]:
            return dense(pool, keys, **kw)
        cpg, before, keys_c = kw["cells_per_group"], pool.to("cpu", copy=True), keys.cpu()
        pool, dropped = dense(pool, keys, **kw)
        want, want_dropped = ga.apply_grouped_updates_plain(before.clone(), keys_c, **kw)
        got = pool.cpu()
        valid = keys_c != 2**31 - 1
        touched = int(torch.unique(keys_c[valid] >> ga.cell_bits(cpg)).numel())
        rec["calls"].append(dict(
            step=rec["n"], groups=got.numel() // cpg, touched=touched,
            parked=max(0, kw["num_groups"] - touched), records=int(valid.sum()),
            equal=torch.equal(got, want), padding=torch.equal(got[-cpg:], before[-cpg:]),
            changed=not torch.equal(got, before), dropped=(int(dropped), int(want_dropped))))
        return pool, dropped

    restore_steps = rec["restore"]

    def restore():
        restore_steps()
        ga.apply_grouped_updates = dense

    ga.apply_grouped_updates = dense_recording
    rec["restore"] = restore
    return rec


def warm_until_inter(builder, course, n_warm, n_max):
    """Drive the first `n_warm` scans of `course`, then, while no INTER
    constraint is found (the revisit's searches run when a submap
    finishes), 8 more at a time up to `n_max`; the pool drained after
    each. Returns the scans driven."""
    pg = builder.pose_graph
    drive(builder, course[:n_warm])
    builder.flush()
    pg.wait_for_all_computations()
    while pg.num_inter_constraints() == 0 and n_warm < n_max:
        drive(builder, course[n_warm:n_warm + 8])
        n_warm += 8
        builder.flush()
        pg.wait_for_all_computations()
    return n_warm


def timed_stretch(tag, builder, course, start, more=lambda: False):
    """The latency, search and phase surfaces cleared, then E2E_TIMED scans
    of `course` from `start`, and 8 more at a time while no loop search and
    periodic solve has ended inside or `more()`, up to E2E_TIMED_MAX; the
    pool drained, then the card synchronized (no capture is underway).
    Checks that a search and a solve fell inside; returns (scans, seconds,
    solves)."""
    pg = builder.pose_graph
    builder.local_slam_latency_seconds.clear()
    pg.constraint_search_seconds.clear()
    pg.phase_seconds.clear()
    spa_steps = builder.graph_counts().get("spa", {}).get("steps", 0)
    t0 = time.perf_counter()
    timed = 0
    while timed < E2E_TIMED_MAX and (timed < E2E_TIMED or not pg.constraint_search_seconds
                                     or "spa" not in pg.phase_seconds or more()):
        n = E2E_TIMED if timed == 0 else 8
        drive(builder, course[start + timed:start + timed + n])
        timed += n
    builder.flush()
    pg.wait_for_all_computations()
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    searches = len(pg.constraint_search_seconds)
    solves = ((builder.graph_counts().get("spa", {}).get("steps", 0) - spa_steps)
              // builder.config.pose_graph.optimization_problem.max_num_iterations)
    print(f"{tag}: timed {timed} scans in {timed_s:.3f} s, holding {searches} loop searches and {solves} "
          f"periodic SPA solves", flush=True)
    check(searches >= 1 and solves >= 1,
          f"{tag}: the timed stretch of {timed} scans held a loop search ({searches}) and a periodic "
          f"solve ({solves})")
    return timed, timed_s, solves


def profile_course(builder, scans):
    """The card's activity (busy ms, the costliest kernels) and the host ms
    over the second half of `scans`, after the first as a warm-up cycle;
    each cycle drives its scans and drains the pool. Only the card is
    recorded: these figures read nothing else, and a profile with host ops
    took ~70 s to read."""
    pg = builder.pose_graph

    def cycle(part):
        def run():
            drive(builder, part)
            builder.flush()
            pg.wait_for_all_computations()
        return run

    half = len(scans) // 2
    prof, wall = warm_profile([cycle(scans[:half]), cycle(scans[half:])], host=False)
    busy, top = card_busy_ms(prof.events())
    return busy, top, wall


def check_backend_programs(tag, builder):
    """The pose graph's compiled programs' counts, printed; a with-initial
    search and the SPA each captured and replayed on the pool threads."""
    counts = builder.graph_counts()
    print(f"{tag}: backend programs (steps = warm-ups + replays; captures): " + "; ".join(
        f"{k} {v['steps']} = {v['warmups']} + {v['replays']}; {v['captures']}"
        for k, v in counts.items() if k not in ("step", "ndt")), flush=True)
    for name in ("search_initial", "spa"):
        c = counts.get(name, {})
        check(c.get("captures", 0) >= 1 and c.get("replays", 0) >= 1,
              f"{tag}: the {name} program was captured and replayed on the pool threads: {c}")
    return counts


def check_trajectory(tag, builder, results):
    """Initialized; every local pose and optimized node pose finite; no
    FailureDetection reset."""
    check(builder.initialized, f"{tag}: MapBuilder initialized")
    for k, r in enumerate(results):
        check(np.all(np.isfinite(r["local_pose"].translation))
              and np.all(np.isfinite(r["local_pose"].rotation)), f"{tag}: local pose {k} finite")
        check(not r["failed"], f"{tag}: scan {k}: FailureDetection reset")
    for k, (_, pose) in enumerate(builder.optimized_node_poses()):
        check(np.all(np.isfinite(pose.translation)) and np.all(np.isfinite(pose.rotation)),
              f"{tag}: node {k} pose finite")


def check_mapping(ga, ac, dev):
    """Phase 8: MapBuilder on the bench_e2e course, see the module docstring."""
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.map_builder import MapBuilder

    cfg = load_config("basic", E2E_OVERRIDES)
    n_warm = E2E_STATIC + E2E_WARM
    course = e2e_course(n_warm + E2E_WARM_MORE + E2E_TIMED_MAX + 2 * E2E_PROFILED, poses=True,
                        radius=E2E_RADIUS)
    builder = MapBuilder(cfg, use_background_threads=True, pipeline_depth=1, device=dev)
    pg = builder.pose_graph
    record_search_chunk(pg)
    rec = record_steps(set(range(E2E_COMPARE)), E2E_BANK_FROM, E2E_BANK_MAX)
    backend_held = hold_backend_graphs()
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.LAUNCHES = 0  # the main path starts: zero the launch counts
    ga.DENSE_LAUNCHES = 0
    ac.LAUNCHES = wo.LAUNCHES = 0
    t_all = time.perf_counter()
    n_warm = warm_until_inter(builder, course, n_warm, E2E_STATIC + E2E_WARM + E2E_WARM_MORE)
    warm_s = time.perf_counter() - t_all
    print(f"mapping: warm-up {n_warm} scans in {warm_s:.1f} s; nodes {len(pg.nodes)} submaps "
          f"{len(pg.submaps)} INTER {pg.num_inter_constraints()}", flush=True)
    accuracy = {"warm_up": e2e_accuracy(pg, course)}
    print(f"mapping: e2e evaluator (tools/torch_e2e_loop_ate.py on its course at bench_e2e's config, truth "
          f"by node time) after the {n_warm}-scan warm-up: {fmt_accuracy(accuracy['warm_up'])}", flush=True)
    warm_phases = dict(sorted(pg.phase_seconds.items()))
    warm_search = list(pg.constraint_search_seconds)
    print(f"mapping: over the warm-up (the backend's captures included): {len(warm_search)} searches, "
          f"{sum(warm_search):.3f} s in all; phase_seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in warm_phases.items()), flush=True)
    timed, timed_s, solves = timed_stretch("mapping", builder, course, n_warm)
    course = course[:n_warm + timed + 2 * E2E_PROFILED]
    lat = np.asarray(builder.local_slam_latency_seconds) * 1e3
    phases = dict(sorted(pg.phase_seconds.items()))
    search = np.asarray(pg.constraint_search_seconds)
    busy, top, prof_wall = profile_course(builder, course[n_warm + timed:])

    spa_before = pg.phase_seconds.get("spa", 0.0)
    builder.finish_trajectory()
    torch.cuda.synchronize()
    final_spa_s = pg.phase_seconds.get("spa", 0.0) - spa_before
    total_s = time.perf_counter() - t_all
    MESH_INPUTS["problem"] = pg._build_problem()  # phase 16 (b): the final pose-graph data
    kept_search_chunk()  # phase 16 (c)
    accuracy["finished"] = e2e_accuracy(pg, course)
    print(f"mapping: e2e evaluator at bench_e2e's config after finish_trajectory() ({len(course)} scans, the "
          f"final optimization run): {fmt_accuracy(accuracy['finished'])}", flush=True)
    from torch_e2e_accuracy import inter_errors, truth

    accuracy["inter"] = inter_errors(pg, truth(course))
    print("mapping: INTER (submap, node, score, error against the true relative pose m, rad): "
          + "; ".join(f"{s} {n} {sc:.3f} {dt:.3f} {dr:.4f}" for s, n, sc, dt, dr in accuracy["inter"]), flush=True)
    launches = {"grouped_apply": ga.LAUNCHES, "grouped_apply_dense": ga.DENSE_LAUNCHES,
                "affine_chain": ac.LAUNCHES}
    K3_BY_PATH["mapping"] = wo.LAUNCHES
    rec["restore"]()
    backend_held["restore"]()

    results = builder.local_trajectory(0)
    stepped = len(results)
    graph_counts = check_graph_counts("mapping", builder.step_counts(), stepped)
    backend_counts = check_backend_programs("mapping", builder)
    held_backend = check_backend_held("mapping", backend_held, ("search_initial", "spa"))
    backend_graphs = measure_backend_graphs(pg)
    inserted = sum(r["inserted"] for r in results)
    inter = pg.num_inter_constraints()
    drops = int(builder.trajectory(0)._lio.frontend.submaps.dense_dropped[0])
    print(f"mapping: {len(course)} scans ({E2E_STATIC} static, {n_warm - E2E_STATIC} warm-up, {timed} "
          f"timed, {E2E_PROFILED} + {E2E_PROFILED} profiled after a warm-up cycle) in {total_s:.1f} s "
          f"(warm-up {warm_s:.1f} s); "
          f"{stepped} stepped, {inserted} inserted")
    print(f"mapping: timed {timed} scans in {timed_s:.3f} s = {timed / timed_s:.3f} scans/s; "
          f"scan latency p50 {np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} ms; "
          f"searches {len(search)} (p50 {np.percentile(search, 50) if len(search) else 0:.3f} s)")
    print(f"mapping: nodes {len(pg.nodes)} submaps {len(pg.submaps)} constraints "
          f"{len(pg.constraints)} INTER {inter}; final optimization {final_spa_s:.2f} s; "
          f"dense groups dropped {drops}; launches {launches}")
    print("mapping: phase_seconds over the timed stretch: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    print(f"mapping: compiled backend beside the eager backend's figures (PERF.md §5; NVIDIA H100 80GB HBM3, 700 W): "
          f"{timed / timed_s:.3f} scans/s (6.203), p50 {np.percentile(lat, 50):.1f} ms (65.3), p99 "
          f"{np.percentile(lat, 99):.1f} ms (87.4), SPA {phases.get('spa', 0.0):.3f} s over the {timed} timed "
          f"scans, {solves} solves and {len(search)} searches (1.50 s over 10 scans); idle share below "
          f"(0.703)", flush=True)
    print(f"mapping: profiled {E2E_PROFILED} scans (card activity only): {prof_wall / E2E_PROFILED:.1f} ms/scan wall, "
          f"card busy {busy / E2E_PROFILED:.2f} ms/scan, idle share {1 - busy / prof_wall:.3f}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    for name, ms, n in top:
        print(f"mapping: profiled card time {ms:9.2f} ms in {n:6d} x {name[:90]}")

    check_trajectory("mapping", builder, results)
    check(drops == 0, f"no dropped dense groups ({drops})")
    check(inter >= 1, "at least one INTER constraint")
    check(final_spa_s > 0.0, "the final optimization ran")
    check(stepped == rec["n"] > 0, f"{stepped} results for {rec['n']} steps")
    # the insert runs masked where the motion filter skips: K1 dense on
    # both banks every step
    check(launches["grouped_apply_dense"] == 2 * stepped, "K1 dense entry twice per stepped scan")
    check(launches["affine_chain"] == stepped, "K2 once per stepped scan")
    check(K3_BY_PATH["mapping"] == stepped,
          f"mapping: K3 {K3_BY_PATH['mapping']} launches for {stepped} steps")

    # K1's dense entry on the main path, held against plain in the bank window
    calls = rec["calls"]
    check(rec["finished"], f"a submap finished in the bank window (steps {E2E_BANK_FROM}-"
          f"{rec['end'] - 1})")
    check(len(calls) == 2 * (rec["end"] - E2E_BANK_FROM), "recorded both dense banks of every "
          "step of the bank window")
    for c in calls:
        check(c["equal"] and c["padding"] and c["dropped"][0] == c["dropped"][1] == 0,
              f"K1 dense entry on the card against plain at step {c['step']}: {c}")
    inserting = [c for c in calls if c["records"]]
    check(inserting and all(c["changed"] for c in inserting), "the window's inserts wrote the banks")
    parks = {}
    for c in inserting:
        parks.setdefault(c["groups"], []).append(c["parked"])
    check(any(max(v) > 0 for v in parks.values()), "steps parked on the padding group")
    print(f"mapping: K1 dense entry of the eager step held at steps {E2E_BANK_FROM}-{rec['end'] - 1} "
          f"(submap finished at step {rec['finished'][0]}): {len(calls)} calls ({len(inserting)} "
          f"with records) bit-identical to plain on the CPU, dropped 0, padding group unchanged; "
          + "; ".join(f"{g}-group bank: {min(v)}-{max(v)} of 256 steps parked"
                      for g, v in sorted(parks.items())))
    check(sorted(rec["held"]) == list(range(E2E_BANK_FROM, rec["end"])), "held every step of the bank window")
    held = check_held("mapping", rec["held"])

    # steps again on the CPU (K1, K2 plain), each from the card's pre-step
    # state and input: the first E2E_COMPARE, then the start of the bank
    # window and the steps either side of the submap finish
    from dliom_tpu_torch.frontend.lio import lio_step

    fin = rec["finished"][0]
    compared = sorted(set(range(E2E_COMPARE)) | {E2E_BANK_FROM, E2E_BANK_FROM + 1, fin, fin + 1})
    worst = 0.0
    for k in compared:
        state, inp = rec["steps"][k]
        _, res = lio_step(state, inp, cfg.trajectory_builder)
        g = results[k]["local_pose"]
        d = max(float(np.abs(g.translation - res.scan.local_pose.translation.numpy()).max()),
                float(np.abs(g.rotation - res.scan.local_pose.rotation.numpy()).max()))
        worst = max(worst, d)
        check(d <= POSE_ATOL, f"mapping step {k}: CUDA vs CPU pose differ by {d:.3e}")
        check(bool(res.scan.inserted) == results[k]["inserted"], f"mapping step {k} inserted")
        check((int(res.scan.finished_submap) >= 0) == (k == fin) or k < E2E_BANK_FROM,
              f"mapping step {k}: the CPU finishes a submap where the card does")
    print(f"mapping: steps {compared} re-run on the CPU from the card's state: largest "
          f"pose difference {worst:.3e} (tolerance {POSE_ATOL})")
    return launches, {"scans_per_s": timed / timed_s, "timed_scans": timed, "timed_solves": solves,
                      "warm_up_scans": n_warm - E2E_STATIC,
                      "compiled_step": graph_counts, "graph_vs_eager": held,
                      "p50_ms": float(np.percentile(lat, 50)),
                      "p99_ms": float(np.percentile(lat, 99)), "inter": inter,
                      "nodes": len(pg.nodes), "submaps": len(pg.submaps),
                      "idle_share": 1 - busy / prof_wall, "phase_seconds": phases, "e2e_accuracy": accuracy,
                      "final_spa_s": final_spa_s, "search_s": search.tolist(),
                      "warm_up_phase_seconds": warm_phases, "warm_up_search_s": warm_search,
                      "backend_counts": backend_counts, "backend_held": held_backend,
                      "backend_graphs": backend_graphs, "programs_mib": programs_memory(pg)}


def programs_memory(pg, tag="mapping"):
    """The device memory (MiB allocated, reserved) that the pose graph's
    programs held: what dropping them (as dropping the pose graph does)
    gives back, unused cache emptied."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    n = sum(len(gs) for gs in pg.programs().values())
    pg._programs_by_thread.clear()
    pg._spa_graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    mib = [(b - a) / 2**20 for a, b in zip((torch.cuda.memory_allocated(), torch.cuda.memory_reserved()), before)]
    print(f"{tag}: the pose graph's {n} programs (graphs, static buffers, pools, static grids) held "
          f"{mib[0]:.1f} MiB allocated, {mib[1]:.1f} MiB reserved; freed with them", flush=True)
    check(mib[1] > 0, f"{tag}: dropping the pose graph's programs gave back no memory ({mib})")
    return {"allocated": mib[0], "reserved": mib[1]}


def campus_course(n_scans):
    """Phase 9's course for `campus`: bench.py's scan world (8000 returns
    per scan) and phase 8's IMU recipe at 100 Hz, a level body moving from
    the first scan (CAMPUS_V0 along x) under tests/test_dynamic_init.py's
    time-varying acceleration (1.4 cos 1.8t, 1.0 sin 1.8t), a scan every
    0.1 s. Per scan: its IMU samples [(t, acc, gyr)], its stamp, points,
    point times and the true velocity."""
    from dliom_tpu_torch.io.synthetic import ImuNoise, ImuSimulator, SyntheticWorld
    from dliom_tpu_torch.transform.rigid import Rigid3

    period = 0.1
    world = SyntheticWorld.create()
    sim = ImuSimulator(rate=100.0, noise=ImuNoise(acc_noise=0.02, gyr_noise=0.002,
                                                  gyr_bias0=(0.0, 0.0, 0.004)), gravity=G, seed=5)
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)

    def velocity(tau):
        return np.array([CAMPUS_V0 + 1.4 * np.sin(1.8 * tau) / 1.8, (1.0 - np.cos(1.8 * tau)) / 1.8, 0.0])

    course, t, p = [], 0.0, np.zeros(3)
    for k in range(n_scans):
        v0, v1 = velocity(k * period), velocity((k + 1) * period)
        p1 = p + 0.5 * (v0 + v1) * period  # exact under the interval's constant acceleration
        dts, accs, gyrs, mask = sim.between(Rigid3(q, p.astype(np.float32)), Rigid3(q, p1.astype(np.float32)),
                                            v0, v1, period, 64)
        imu = []
        for i in range(int(mask.sum())):
            t += float(dts[i])
            imu.append((t, accs[i], gyrs[i]))
        pts, ptimes = world.cast_scan(Rigid3(q, p1.astype(np.float32)))
        course.append((imu, t, pts, ptimes, v1))
        p = p1
    return course


def drive_until(builder, course, steps):
    """Feed `course` scan by scan until `steps` scans were stepped (the
    builder runs unpipelined); returns the number of scans fed."""
    for k, (imu, t, pts, ptimes, _) in enumerate(course):
        for ti, acc, gyr in imu:
            builder.add_imu_data(ti, acc, gyr)
        builder.add_range_data(t, pts, ptimes)
        if len(builder.local_trajectory(0)) >= steps:
            return k + 1
    raise RuntimeError(f"check failed: the course ended before {steps} stepped scans")


def record_initializer(builder):
    """Wrap the builder's dynamic initializer: keep its calls (to replay
    them on the CPU), count its segments (each a K2 launch), time its scans
    and, with a synchronize either side, its preintegrations and its NDT
    odometry (the compiled `build_field` + `ndt_match`). Returns the dict
    it fills."""
    init = builder.trajectory(0)._dyn_init
    rec = {"calls": [], "segments": 0, "scans": 0, "seconds": 0.0, "result": None,
           "parts": {"preintegrate": 0.0, "ndt_odometry": 0.0}, "odometry_s": []}
    add_imu, add_scan, segment = init.add_imu, init.add_scan, init._segment_preint

    def timed(part, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec["parts"][part] += time.perf_counter() - t0
            if part == "ndt_odometry":
                rec["odometry_s"].append(time.perf_counter() - t0)
            return out
        return run

    segment = timed("preintegrate", segment)
    init._odometry = timed("ndt_odometry", init._odometry)

    def restore():
        del init._odometry

    def imu(t, acc, gyr):
        rec["calls"].append(("imu", t, acc, gyr))
        return add_imu(t, acc, gyr)

    def scan(t, points):
        rec["calls"].append(("scan", t, points))
        t0 = time.perf_counter()
        out = add_scan(t, points)
        torch.cuda.synchronize()
        rec["seconds"] += time.perf_counter() - t0
        rec["scans"] += 1
        if out is not None:
            rec["result"] = out
        return out

    def counted_segment():
        rec["segments"] += 1
        return segment()

    init.add_imu, init.add_scan, init._segment_preint = imu, scan, counted_segment
    rec["restore"] = restore
    return rec


def check_campus(ac, dev):
    """Phase 9 (a): campus as shipped, initialized in motion, see the
    module docstring."""
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.frontend.lio import lio_step
    from dliom_tpu_torch.imu.dynamic_initializer import DynamicInitializer
    from dliom_tpu_torch.map_builder import MapBuilder
    from dliom_tpu_torch.transform.rigid import quat_rotate

    cfg = load_config("campus")
    tb = cfg.trajectory_builder
    check(tb.enable_ndt_initialization and tb.enable_gravity_factor
          and tb.submaps.dense_apply_groups == 0, "campus ships NDT init, gravity factor, per-record insert")
    course = campus_course(2 * (tb.frames_for_dynamic_initialization + 1) + CAMPUS_STEPS
                           + 2 * CAMPUS_PROFILED)
    builder = MapBuilder(cfg, device=dev)
    init = record_initializer(builder)
    ndt_held = hold_backend_graphs(("ndt",))
    rec = hold_steps(keep=lambda k, _: k < CAMPUS_COMPARE)
    from dliom_tpu_torch.imu import window_optimizer as wo

    ac.LAUNCHES = wo.LAUNCHES = 0  # the main path starts: zero the launch counts
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fed = drive_until(builder, course, CAMPUS_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ac.LAUNCHES
    K3_BY_PATH["campus"] = wo.LAUNCHES
    compiled_mib = (torch.cuda.max_memory_allocated() / 2**20, torch.cuda.memory_reserved() / 2**20)
    rec["restore"]()
    init["restore"]()
    ndt_held["restore"]()
    results = builder.local_trajectory(0)[:]
    stepped = len(results)
    graph_counts = check_graph_counts("campus", builder.step_counts(), stepped)
    check(K3_BY_PATH["campus"] == stepped,
          f"campus: K3 {K3_BY_PATH['campus']} launches for {stepped} steps")
    ndt_counts = builder.graph_counts()["ndt"]
    print(f"campus: NDT odometry program: {ndt_counts['steps']} steps = {ndt_counts['warmups']} warm-up + "
          f"{ndt_counts['replays']} replays; {ndt_counts['captures']} captures", flush=True)
    check(ndt_counts["warmups"] == ndt_counts["captures"] == 1
          and ndt_counts["replays"] == ndt_counts["steps"] - 1 >= 1, f"campus: NDT odometry counts {ndt_counts}")
    held_ndt = check_backend_held("campus", ndt_held, ("ndt",))
    ndt_ms, ndt_kernels = replay_ms(builder.trajectory(0)._dyn_init.odometry_graph.graph)
    print(f"campus: one NDT odometry replay: {ndt_ms:.3f} ms device time, {ndt_kernels} kernels", flush=True)
    # the eager step's peak memory from the last step's state and input
    traj = builder.trajectory(0)
    pre, inp = tree_clone(traj._lio), tree_clone(traj._step.inp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_mib = torch.cuda.memory_allocated() / 2**20
    without_launches(lambda: lio_step(pre, inp, tb))
    torch.cuda.synchronize()
    eager_mib = torch.cuda.max_memory_allocated() / 2**20
    del pre, inp
    print(f"campus: peak device memory over the compiled run {compiled_mib[0]:.0f} MiB allocated, "
          f"{compiled_mib[1]:.0f} MiB reserved (the graph pool included); one eager step from copies of "
          f"the same state and input {eager_mib:.0f} MiB allocated at its peak, "
          f"{eager_mib - held_mib:.0f} MiB above the {held_mib:.0f} MiB held before it (the builder's "
          f"banks and those copies)", flush=True)
    lat = np.asarray(builder.local_slam_latency_seconds[CAMPUS_COMPARE:]) * 1e3

    # where a campus step's time goes on the card: its activity only, as in
    # phase 8 (a profile with host ops took tens of seconds to read; phase 6
    # keeps the per-span host profile)
    def cycle(scans):
        return lambda: drive(builder, [c[:4] for c in scans])

    prof, prof_wall = warm_profile([cycle(course[fed:fed + CAMPUS_PROFILED]),
                                    cycle(course[fed + CAMPUS_PROFILED:fed + 2 * CAMPUS_PROFILED])], host=False)
    events = prof.events()
    busy, top = card_busy_ms(events)
    idle = 1 - busy / prof_wall
    print(f"campus profile: {CAMPUS_PROFILED} scans (card activity only), {prof_wall / CAMPUS_PROFILED:.1f} "
          f"ms/scan wall, card busy {busy / CAMPUS_PROFILED:.2f} ms/scan, "
          f"{len(device_events(events)) / CAMPUS_PROFILED:.0f} device activities/scan, idle share {idle:.3f}")
    for name, ms, n in top:
        print(f"campus profile: card time {ms:9.2f} ms in {n:6d} x {name[:90]}")

    res = init["result"]
    check(res is not None and builder.initialized, "campus: dynamic initialization triggered")
    init_scan = init["scans"] - 1
    up = float(quat_rotate(res.nav.rotation, torch.tensor([0.0, 0.0, 1.0], device=dev))[2])
    v_err = float(np.linalg.norm(res.nav.velocity.cpu().numpy() - course[init_scan][4]))
    print(f"campus: initialized in motion on scan {init_scan} after {init['segments']} segments, "
          f"initializer {init['seconds']:.3f} s over {init['scans']} scans ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in init["parts"].items()) + f"); up.z {up:.5f}, velocity "
          f"{np.round(res.nav.velocity.cpu().numpy(), 3).tolist()} vs truth "
          f"{np.round(course[init_scan][4], 3).tolist()} (error {v_err:.3f} m/s)", flush=True)
    odo = init["odometry_s"]
    print(f"campus: initializer {init['seconds']:.3f} s, NDT odometry {init['parts']['ndt_odometry']:.3f} s over "
          f"{len(odo)} matches (the first, the eager warm-up and the capture, {odo[0]:.3f} s; the replays "
          f"{np.round(odo[1:], 4).tolist()} s, the first {HELD_REPLAYS} with their eager re-runs; without those "
          f"{init['parts']['ndt_odometry'] - held_ndt['ndt']['eager_s']:.3f} s) beside the eager initializer's 3.052 s, "
          f"NDT (build_field + ndt_match) 2.948 s (PERF.md; NVIDIA H100 80GB HBM3, 700 W)", flush=True)
    check(up > 0.99, f"campus: gravity-aligned after initialization (up.z {up:.4f})")
    check(v_err < 0.4, f"campus: initial velocity within 0.4 m/s of the truth ({v_err:.3f})")

    # the initializer again on the CPU (plain versions) from the same inputs
    cpu_init = DynamicInitializer(tb, "cpu")
    cpu_res = None
    for call in init["calls"]:
        out = cpu_init.add_imu(*call[1:]) if call[0] == "imu" else cpu_init.add_scan(*call[1:])
        cpu_res = out if out is not None else cpu_res
    check(cpu_res is not None, "campus: the CPU initializer triggers on the same inputs")
    init_diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(res.nav, cpu_res.nav))
    print(f"campus: initializer CUDA vs CPU: largest nav difference {init_diff:.3e} (tolerance {INIT_ATOL})")
    check(init_diff <= INIT_ATOL, f"campus: initializer CUDA vs CPU differ by {init_diff:.3e}")

    submaps = builder.trajectory(0)._lio.frontend.submaps
    drops = int(submaps.dense_dropped[0])
    gravity = int(torch.stack(rec["gravity_valid"]).sum())
    for k, r in enumerate(results):
        pose = r["local_pose"]
        check(np.all(np.isfinite(pose.translation)) and np.all(np.isfinite(pose.rotation)),
              f"campus: local pose {k} finite")
        check(not r["failed"], f"campus: scan {k}: FailureDetection reset")
    check(drops == 0, f"campus: no dropped dense groups ({drops})")
    check(gravity > 0, "campus: the gravity factor was valid on some step")
    check(launches == init["segments"] + stepped,
          f"campus: K2 {launches} launches, not {init['segments']} segments + {stepped} steps")
    steps_s = wall - init["seconds"]
    print(f"campus: {fed} scans fed, {stepped} stepped, {int(sum(r['inserted'] for r in results))} inserted; "
          f"gravity factor valid on {gravity} steps; dense groups dropped {drops}; K2 launches {launches} "
          f"= {init['segments']} segments + {stepped} steps; {stepped / steps_s:.3f} scans/s over the "
          f"stepped scans ({steps_s:.2f} s, the first {CAMPUS_COMPARE} copied to the host); scan latency "
          f"p50 {np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} ms (steps "
          f"{CAMPUS_COMPARE}-{stepped - 1})", flush=True)

    worst = 0.0
    for k in range(CAMPUS_COMPARE):
        state, inp = rec["steps"][k]
        _, out = lio_step(state, inp, tb)
        g = results[k]["local_pose"]
        d = max(float(np.abs(g.translation - out.scan.local_pose.translation.numpy()).max()),
                float(np.abs(g.rotation - out.scan.local_pose.rotation.numpy()).max()))
        worst = max(worst, d)
        check(d <= POSE_ATOL, f"campus step {k}: CUDA vs CPU pose differ by {d:.3e}")
    print(f"campus: steps 0-{CAMPUS_COMPARE - 1} re-run on the CPU from the card's state: largest pose "
          f"difference {worst:.3e} (tolerance {POSE_ATOL})")
    return launches, {"scans_per_s": stepped / steps_s, "p50_ms": float(np.percentile(lat, 50)),
                      "p99_ms": float(np.percentile(lat, 99)), "idle_share": idle,
                      "compiled_step": graph_counts, "compiled_peak_mib": compiled_mib[0],
                      "compiled_reserved_mib": compiled_mib[1], "eager_step_peak_mib": eager_mib,
                      "init_seconds": init["seconds"], "init_parts": init["parts"],
                      "ndt_odometry_s": init["odometry_s"], "ndt_counts": ndt_counts, "ndt_held": held_ndt,
                      "ndt_replay_ms": ndt_ms, "ndt_replay_kernels": ndt_kernels,
                      "init_scan": init_scan, "init_velocity_error": v_err, "init_cuda_vs_cpu": init_diff}


def record_brick_calls(spec):
    """Hold every step of the main path against the eager step from the
    same pre-step state (`hold_steps`), and every high-grid brick insert
    and slot reset of that eager step against the same call on a CPU copy
    of its inputs, bit for bit: graph = eager, eager call = CPU. From now
    until the first insert with records after the second pending reset
    (the first that recycles a slot). Returns the dict it fills, with the
    held steps under "hold"."""
    from dliom_tpu_torch.mapping import submap

    rec = {"open": True, "inserts": [], "resets": []}
    hold = rec["hold"] = hold_steps(lambda k, _: rec["open"])
    insert, reset = submap._insert_brick_slots, submap.reset_slot
    cpu = tree_cpu

    def same(got, want):
        return all(torch.equal(getattr(got, f).cpu(), getattr(want, f)) for f in got._fields)

    def recording_insert(bank, origins, hits, masks, **kw):
        if not (hold["eager"] and rec["open"] and kw["spec"] == spec):
            return insert(bank, origins, hits, masks, **kw)
        before = cpu((bank, origins, hits, masks))
        out = insert(bank, origins, hits, masks, **kw)
        rec["inserts"].append(dict(equal=same(out, insert(*before, **kw)), records=int(masks.sum()),
                                   counts=out.counts.tolist()))
        if sum(r["pending"] for r in rec["resets"]) >= 2 and rec["inserts"][-1]["records"]:
            rec["open"] = False
        return out

    def recording_reset(bank, bspec, slot, pending=True):
        if not (hold["eager"] and rec["open"] and bspec == spec):
            return reset(bank, bspec, slot, pending)
        before = cpu((bank, slot, pending))
        out = reset(bank, bspec, slot, pending)
        rec["resets"].append(dict(equal=same(out, reset(before[0], bspec, *before[1:])),
                                  pending=bool(before[2]), slot=int(before[1])))
        return out

    submap._insert_brick_slots, submap.reset_slot = recording_insert, recording_reset

    def restore():
        hold["restore"]()
        submap._insert_brick_slots, submap.reset_slot = insert, reset

    rec["restore"] = restore
    return rec


def check_viral(ac, dev):
    """Phase 9 (b): viral's per-record brick insert, see the module
    docstring."""
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.map_builder import MapBuilder
    from dliom_tpu_torch.mapping.submap import brick_spec

    cfg = load_config("viral", {"trajectory_builder": {"submaps": {"num_range_data": VIRAL_RANGE_DATA}}})
    spec = brick_spec(cfg.trajectory_builder.submaps)
    check(spec.apply_groups == 0 and spec.resolution == 0.1, "viral ships a 0.1 m per-record brick grid")
    course = e2e_course(E2E_STATIC + VIRAL_MOVING)
    builder = MapBuilder(cfg, pipeline_depth=1, device=dev)
    rec = record_brick_calls(spec)
    from dliom_tpu_torch.imu import window_optimizer as wo

    ac.LAUNCHES = wo.LAUNCHES = 0  # the main path starts: zero the launch counts
    window_scans, t0 = None, None
    for k, scan in enumerate(course):
        drive(builder, [scan])
        if window_scans is None and not rec["open"]:
            builder.flush()
            torch.cuda.synchronize()
            window_scans, t0 = k + 1, time.perf_counter()
            builder.local_slam_latency_seconds.clear()
    builder.flush()
    torch.cuda.synchronize()
    check(t0 is not None, "viral: a slot was recycled within the course")
    timed_s = time.perf_counter() - t0
    launches = ac.LAUNCHES
    K3_BY_PATH["viral"] = wo.LAUNCHES
    rec["restore"]()

    results = builder.local_trajectory(0)
    stepped = len(results)
    graph_counts = check_graph_counts("viral", builder.step_counts(), stepped)
    check(K3_BY_PATH["viral"] == stepped,
          f"viral: K3 {K3_BY_PATH['viral']} launches for {stepped} steps")
    held = check_held("viral", rec["hold"]["held"])
    sm = builder.trajectory(0)._lio.frontend.submaps
    drops = {"brick": int(sm.high_brick.dropped[0]), "dense": int(sm.dense_dropped[0])}
    for k, r in enumerate(results):
        pose = r["local_pose"]
        check(np.all(np.isfinite(pose.translation)) and np.all(np.isfinite(pose.rotation)),
              f"viral: local pose {k} finite")
        check(not r["failed"], f"viral: scan {k}: FailureDetection reset")
    check(not any(drops.values()), f"viral: no dropped grid updates {drops}")
    check(launches == stepped, f"viral: K2 {launches} launches for {stepped} stepped scans")
    inserts, resets = rec["inserts"], rec["resets"]
    differ = [c for c in inserts + resets if not c["equal"]]
    check(not differ, f"viral: brick calls on the card differ from the CPU: {differ}")
    pending = [c for c in resets if c["pending"]]
    check(len(pending) >= 2 and any(c["records"] for c in inserts),
          "viral: the window crossed a slot recycle")
    lat = np.asarray(builder.local_slam_latency_seconds) * 1e3
    timed = len(course) - window_scans
    print(f"viral: {len(course)} scans ({E2E_STATIC} static), {stepped} stepped, "
          f"{int(sum(r['inserted'] for r in results))} inserted; brick inserts of the first "
          f"{window_scans} scans ({len(inserts)} calls, "
          f"{sum(1 for c in inserts if c['records'])} with records) "
          f"and {len(resets)} slot resets ({len(pending)} pending, slots {[c['slot'] for c in pending]}) "
          f"of the eager steps held against the graph bit-identical to the CPU; pool groups {inserts[-1]['counts']}; drops {drops}; K2 launches "
          f"{launches}; timed {timed} scans after the window in {timed_s:.3f} s = {timed / timed_s:.3f} "
          f"scans/s, scan latency p50 {np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} ms",
          flush=True)
    return launches, {"scans_per_s": timed / timed_s, "p50_ms": float(np.percentile(lat, 50)),
                      "p99_ms": float(np.percentile(lat, 99)), "bit_identical_inserts": len(inserts),
                      "bit_identical_resets": len(resets), "compiled_step": graph_counts,
                      "graph_vs_eager": held}


def check_correlative(ac, dev):
    """Phase 9 (c): campus with the online correlative matcher; each
    pre-search on the card against the same call on the CPU."""
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.map_builder import MapBuilder
    from dliom_tpu_torch.ops import real_time_correlative as rtc

    cfg = load_config("campus", {"trajectory_builder": {"use_online_correlative_scan_matching": True}})
    tb = cfg.trajectory_builder
    course = campus_course(2 * (tb.frames_for_dynamic_initialization + 1) + RTC_STEPS)
    builder = MapBuilder(cfg, device=dev)
    calls, match = [], rtc.match
    hold = hold_steps(lambda k, _: True)

    def recording(initial, points, mask, values, spec, **kw):
        if not hold["eager"]:
            return match(initial, points, mask, values, spec, **kw)
        t0 = time.perf_counter()
        out = match(initial, points, mask, values, spec, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        host = [x.cpu() for x in (initial.rotation, initial.translation, points, mask, values)]
        want = match(type(initial)(*host[:2]), *host[2:], spec, **dict(kw, base=kw["base"].cpu()))
        calls.append(dict(index=(int(out.index), int(want.index)), ms=ms,
                          score=(float(out.score), float(want.score))))
        return out

    rtc.match = recording
    from dliom_tpu_torch.imu import window_optimizer as wo

    ac.LAUNCHES = wo.LAUNCHES = 0
    drive_until(builder, course, RTC_STEPS)
    launches = ac.LAUNCHES
    K3_BY_PATH["correlative"] = wo.LAUNCHES
    rtc.match = match
    hold["restore"]()
    graph_counts = check_graph_counts("correlative", builder.step_counts(), RTC_STEPS)
    check(K3_BY_PATH["correlative"] == RTC_STEPS,
          f"correlative: K3 {K3_BY_PATH['correlative']} launches for {RTC_STEPS} steps")
    held = check_held("correlative", hold["held"])
    check(len(calls) == RTC_STEPS, f"correlative: {len(calls)} pre-searches for {RTC_STEPS} steps")
    worst = max(abs(c["score"][0] - c["score"][1]) for c in calls)
    for k, c in enumerate(calls):
        check(c["index"][0] == c["index"][1],
              f"correlative scan {k}: best candidate {c['index']} (card, CPU)")
        check(abs(c["score"][0] - c["score"][1]) <= RTC_SCORE_ATOL,
              f"correlative scan {k}: scores {c['score']}")
    rc = tb.real_time_correlative_scan_matcher
    n_cand = len(rtc._lattice(tb.submaps.high_resolution, rc.linear_search_window,
                              rc.angular_search_window, tb.max_range, rc.max_angular_steps)[0])
    print(f"correlative: {RTC_STEPS} pre-searches over {n_cand} candidates x {tb.max_high_res_points} "
          f"points: "
          f"best candidates {[c['index'][0] for c in calls]} equal to the CPU's, largest score difference "
          f"{worst:.3e} (tolerance {RTC_SCORE_ATOL}) in the eager steps held against the graph; "
          f"{np.median([c['ms'] for c in calls]):.1f} ms per pre-search (median, host clock, eager); "
          f"K2 launches {launches}")
    return launches, {"candidates": n_cand, "score_diff": worst, "compiled_step": graph_counts,
                      "graph_vs_eager": held,
                      "ms": float(np.median([c["ms"] for c in calls]))}


def feed_with_sensors(builder, scans):
    """Phase 10's feed: phase 8's course with the truth as odometry at each
    scan stamp and as a fixed-frame (GPS) position 50 ms after it, so the
    odometry and fixed-frame buffers hold samples at every checkpoint."""
    for imu, t, pts, ptimes, pose in scans:
        for ti, acc, gyr in imu:
            builder.add_imu_data(ti, acc, gyr)
        builder.add_odometry_data(t, pose)
        builder.add_range_data(t, pts, ptimes)
        builder.add_fixed_frame_pose_data(t + 0.05, pose.translation)


def count_steps():
    """Count MapBuilder's steps (`_TrajectoryBuilder._lio_step`), and keep
    each trajectory's compiled step; returns the dict it fills."""
    from dliom_tpu_torch import map_builder

    cls = map_builder._TrajectoryBuilder
    step, box = cls._lio_step, {"n": 0, "graphs": {}}

    def counting(self, arrays):
        box["n"] += 1
        out = step(self, arrays)
        box["graphs"][id(self)] = self._step
        return out

    cls._lio_step = counting
    box["restore"] = lambda: setattr(cls, "_lio_step", step)
    return box


def graphs_counts(box):
    """The counts of the compiled steps a `count_steps` box saw, summed."""
    from dliom_tpu_torch.common.graph import sum_counts

    return sum_counts(box["graphs"].values())


def graph_differences(a, b, pose_atol=0.0, grids=True, map_state=False):
    """Where pose graph `b` differs from `a`: counts, ids, poses (beyond
    `pose_atol`), compressed grids (exact), node data (exact), constraints
    and the fixed-frame, landmark and odometry observations. With
    `map_state` (`b` loaded from a saved map state, which keeps no sensor
    observations and node clouds quantized to 1 mm) the observations are
    skipped and the node clouds compared by their point counts."""
    out = []
    observations = ("fixed_frame_observations", "landmark_observations", "odometry_links")
    clouds = ("high_points", "low_points")

    def pose_diff(x, y):
        return max(float(np.abs(np.asarray(x.rotation) - np.asarray(y.rotation)).max()),
                   float(np.abs(np.asarray(x.translation) - np.asarray(y.translation)).max()))

    for name in ("submaps", "nodes", "constraints") + (() if map_state else observations):
        if len(getattr(a, name)) != len(getattr(b, name)):
            out.append(f"{name}: {len(getattr(a, name))} vs {len(getattr(b, name))}")
    if out:
        return out
    for i, (x, y) in enumerate(zip(a.submaps, b.submaps)):
        if (x.finished, x.trajectory_id, x.index_in_trajectory, list(x.node_ids)) != \
                (y.finished, y.trajectory_id, y.index_in_trajectory, list(y.node_ids)):
            out.append(f"submap {i}: ids")
        if max(pose_diff(x.local_pose, y.local_pose), pose_diff(x.global_pose, y.global_pose)) > pose_atol:
            out.append(f"submap {i}: pose")
        if not np.array_equal(np.asarray(x.histogram), np.asarray(y.histogram)):
            out.append(f"submap {i}: histogram")
        if grids and (x.high is None) != (y.high is None):
            out.append(f"submap {i}: grids present")
        elif grids and x.high is not None:
            for gx, gy in ((x.high, y.high), (x.low, y.low)):
                if not all(torch.equal(u, v) for u, v in zip(gx, gy)):
                    out.append(f"submap {i}: grid")
    for i, (x, y) in enumerate(zip(a.nodes, b.nodes)):
        if (x.time, x.trajectory_id, tuple(x.submap_ids)) != (y.time, y.trajectory_id, tuple(y.submap_ids)):
            out.append(f"node {i}: ids")
        if max(pose_diff(x.local_pose, y.local_pose), pose_diff(x.global_pose, y.global_pose)) > pose_atol:
            out.append(f"node {i}: pose")
        for f in ("high_points", "high_mask", "low_points", "low_mask", "histogram", "gravity_alignment"):
            if map_state and f in clouds:
                continue
            if map_state and f.endswith("_mask"):
                same = np.count_nonzero(getattr(x, f)) == np.count_nonzero(getattr(y, f))
            else:
                same = np.array_equal(np.asarray(getattr(x, f)), np.asarray(getattr(y, f)))
            if not same:
                out.append(f"node {i}: {f}")
    for i, (x, y) in enumerate(zip(a.constraints, b.constraints)):
        if (x.submap_id, x.node_id, x.tag, x.translation_weight, x.rotation_weight) != \
                (y.submap_id, y.node_id, y.tag, y.translation_weight, y.rotation_weight) \
                or pose_diff(x.relative, y.relative) > pose_atol:
            out.append(f"constraint {i}")
    if map_state:
        return out
    for i, (x, y) in enumerate(zip(a.fixed_frame_observations, b.fixed_frame_observations)):
        if x[0] != y[0] or x[2] != y[2] or not np.array_equal(x[1], y[1]):
            out.append(f"fixed-frame observation {i}")
    for i, (x, y) in enumerate(zip(a.odometry_links, b.odometry_links)):
        if x[:2] != y[:2] or pose_diff(x[2], y[2]) > pose_atol:
            out.append(f"odometry link {i}")
    return out


def check_checkpoint(ga, ac, dev, tmp):
    """Phase 10 (a): a live checkpoint at bench_e2e's config, see the module
    docstring. Returns (builder A, config, launches, numbers)."""
    import os

    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.io.serialization import state_leaves
    from dliom_tpu_torch.map_builder import MapBuilder, map_builder_from_checkpoint

    cfg = load_config("basic", E2E_OVERRIDES).override(
        {"trajectory_builder": {"submaps": {"num_range_data": CKPT_RANGE_DATA}}})
    course = e2e_course(E2E_STATIC + 8 * CKPT_RANGE_DATA, poses=True)
    a = MapBuilder(cfg, pipeline_depth=1, device=dev)
    pg = a.pose_graph
    steps = count_steps()
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.DENSE_LAUNCHES = 0  # the main path starts: zero the launch counts
    ac.LAUNCHES = wo.LAUNCHES = 0
    t0 = time.perf_counter()
    fed, finished_at = 0, None
    for scan in course:
        feed_with_sensors(a, [scan])
        fed += 1
        if finished_at is None and any(s.finished for s in pg.submaps):
            finished_at = fed
        if finished_at is not None and fed == finished_at + CKPT_AFTER_FINISH:
            break
    a.flush()
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    launches_a = {"grouped_apply_dense": ga.DENSE_LAUNCHES, "affine_chain": ac.LAUNCHES}
    steps_a = steps["n"]
    K3_BY_PATH["checkpoint"] = wo.LAUNCHES
    check(K3_BY_PATH["checkpoint"] == steps_a,
          f"phase 10: builder A: K3 {K3_BY_PATH['checkpoint']} launches for {steps_a} steps")
    counts_a = check_graph_counts("checkpoint A", a.step_counts(), steps_a)
    check(finished_at is not None, "phase 10: a submap finished on the course")
    check(launches_a["grouped_apply_dense"] == 2 * steps_a and launches_a["affine_chain"] == steps_a,
          f"phase 10: builder A launches {launches_a} for {steps_a} steps")
    t = a.trajectory(0)
    check(bool(t._ff_buffer) and len(t._odom_buffer) > 0 and pg.fixed_frame_observations
          and pg.odometry_links, "phase 10: fixed-frame and odometry buffers and observations non-empty")
    active = pg.submaps[-1]
    print(f"checkpoint: builder A fed {fed} scans ({steps_a} stepped) in {drive_s:.1f} s; first submap "
          f"finished on scan {finished_at}; submaps {len(pg.submaps)} (finished "
          f"{sum(s.finished for s in pg.submaps)}, the newest holds {len(active.node_ids)} of "
          f"{2 * CKPT_RANGE_DATA} nodes), nodes {len(pg.nodes)}", flush=True)

    path = os.path.join(tmp, "live.npz")
    t0 = time.perf_counter()
    a.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = map_builder_from_checkpoint(path, cfg, pipeline_depth=1, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    la, lb = list(state_leaves(a.trajectory(0)._lio)), list(state_leaves(b.trajectory(0)._lio))
    check([p for p, _ in la] == [p for p, _ in lb], "phase 10: the same LioState fields")
    for (p, x), (_, y) in zip(la, lb):
        check(y.device == x.device and y.device.type == dev.type and y.dtype == x.dtype and torch.equal(x, y),
              f"phase 10: restored LioState field {p} equals A's on the card")
    diff = graph_differences(pg, b.pose_graph)
    check(not diff, f"phase 10: restored pose graph differs: {diff[:5]}")
    tb_ = b.trajectory(0)
    check(len(tb_._ff_buffer) == len(t._ff_buffer) and tb_._odom_buffer._times == t._odom_buffer._times
          and tb_._imu_times == t._imu_times and tb_._pg_submap_ids == t._pg_submap_ids,
          "phase 10: restored trajectory buffers")
    print(f"checkpoint: {size} bytes; save {save_s:.3f} s, restore {restore_s:.3f} s; {len(la)} LioState "
          f"tensors bit-identical on the card; pose graph ({len(pg.submaps)} submaps, {len(pg.nodes)} nodes, "
          f"{len(pg.constraints)} constraints, {len(pg.fixed_frame_observations)} fixed-frame, "
          f"{len(pg.odometry_links)} odometry) equal", flush=True)

    nxt = course[fed:fed + CKPT_NEXT]
    check(len(nxt) == CKPT_NEXT, "phase 10: the course has scans left after the checkpoint")
    feed_with_sensors(a, nxt)
    a.flush()
    steps["n"] = 0
    ga.DENSE_LAUNCHES = 0  # the resumed builder's main path: zero the launch counts
    ac.LAUNCHES = wo.LAUNCHES = 0
    t0 = time.perf_counter()
    feed_with_sensors(b, nxt)
    b.flush()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches_b = {"grouped_apply_dense": ga.DENSE_LAUNCHES, "affine_chain": ac.LAUNCHES}
    steps_b = steps["n"]
    check(wo.LAUNCHES == steps_b, f"phase 10: builder B: K3 {wo.LAUNCHES} launches for {steps_b} steps")
    K3_BY_PATH["checkpoint"] += wo.LAUNCHES
    steps["restore"]()
    # B's trajectory builders are new: its graph warms up and captures again
    counts_b = check_graph_counts("checkpoint B", b.step_counts(), steps_b)
    check(steps_b == CKPT_NEXT, f"phase 10: B stepped {steps_b} of {CKPT_NEXT} scans")
    check(launches_b["grouped_apply_dense"] == 2 * steps_b and launches_b["affine_chain"] == steps_b,
          f"phase 10: builder B launches {launches_b} for {steps_b} steps")
    pb = b.pose_graph
    check((len(pb.nodes), len(pb.submaps), len(pb.constraints)) == (len(pg.nodes), len(pg.submaps),
                                                                     len(pg.constraints)),
          "phase 10: A and B hold as many nodes, submaps and constraints")
    differ = graph_differences(pg, pb)
    exact = not differ
    check(not [d for d in differ if "histogram" in d],
          f"phase 10: A's and B's node and submap histograms differ: {differ[:5]}")
    worst = 0.0
    for x, y in zip(pg.nodes, pb.nodes):
        for u, v in ((x.local_pose, y.local_pose), (x.global_pose, y.global_pose)):
            worst = max(worst, float(np.abs(u.translation - v.translation).max()),
                        float(np.abs(u.rotation - v.rotation).max()))
    check(exact or worst <= POSE_ATOL, f"phase 10: A and B poses differ by {worst:.3e} > {POSE_ATOL}")
    print(f"checkpoint: A and B fed the next {CKPT_NEXT} scans (B {resume_s:.2f} s): B launched K1 dense "
          f"{launches_b['grouped_apply_dense']} and K2 {launches_b['affine_chain']} for {steps_b} steps; "
          + ("graphs bit-identical" if exact else f"not bit-identical ({len(differ)} differences, the first "
                                                  f"{differ[:4]}); poses within {worst:.3e}"),
          flush=True)
    launches = {k: launches_a[k] + launches_b[k] for k in launches_a}
    resumed = {"cfg": cfg, "path": path, "b": b, "scans": nxt, "b_seconds": resume_s}
    return a, cfg, launches, {"bytes": size, "save_s": save_s, "restore_s": restore_s,
                              "bit_identical": exact, "pose_diff": worst, "scans_a": fed,
                              "steps_a": steps_a, "steps_b": steps_b, "compiled_step_a": counts_a,
                              "compiled_step_b": counts_b}, resumed


def check_pbstream(a, cfg, dev, tmp):
    """Phase 10 (b): A's graph through a pbstream and back onto the card."""
    import os

    from dliom_tpu_torch.backend.compression import decompress
    from dliom_tpu_torch.io.pbstream import PbstreamReader, write_pbstream, write_range_data_pbstream
    from dliom_tpu_torch.map_builder import map_builder_from_state

    pg = a.pose_graph
    path, range_path = os.path.join(tmp, "map.pbstream"), os.path.join(tmp, "range.pbstream")
    t0 = time.perf_counter()
    write_pbstream(path, pg)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = map_builder_from_state(path, cfg, pure_localization=True, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lpg = loaded.pose_graph
    check((len(lpg.nodes), len(lpg.submaps), len(lpg.constraints))
          == (len(pg.nodes), len(pg.submaps), len(pg.constraints)), "phase 10: pbstream counts")
    worst, grids = 0.0, 0
    hi, lo = pg._hi_spec, pg._lo_spec
    for x, y in zip(pg.submaps + pg.nodes, lpg.submaps + lpg.nodes):
        worst = max(worst, float(np.abs(x.global_pose.translation - y.global_pose.translation).max()),
                    float(np.abs(x.global_pose.rotation - y.global_pose.rotation).max()),
                    float(np.abs(x.local_pose.translation - y.local_pose.translation).max()))
    for x, y in zip(pg.submaps, lpg.submaps):
        if x.finished and x.high is not None:
            check(y.high is not None and y.high.indices.device.type == dev.type, "phase 10: grids on the card")
            check(torch.equal(decompress(x.high, hi), decompress(y.high, hi))
                  and torch.equal(decompress(x.low, lo), decompress(y.low, lo)),
                  "phase 10: a finished submap's grids decompress identically")
            grids += 1
    check(grids >= 1 and worst <= 1e-5, f"phase 10: {grids} grids, poses within {worst:.3e} (1e-5)")
    states = lpg.trajectory_states()
    check(all(states[s.trajectory_id] == "FROZEN" and s.frozen for s in lpg.submaps),
          "phase 10: the loaded trajectories are FROZEN")
    write_range_data_pbstream(range_path, pg)
    messages = sum(1 for _ in PbstreamReader(range_path))
    check(messages == len(pg.nodes) + 1, f"phase 10: {messages} range-data messages")
    print(f"pbstream: {os.path.getsize(path)} bytes written in {write_s:.3f} s, loaded frozen on the card "
          f"in {load_s:.3f} s; {grids} finished submaps' grids identical, poses within {worst:.3e}; "
          f"range data {messages} messages ({os.path.getsize(range_path)} bytes)", flush=True)
    return {"bytes": os.path.getsize(path), "write_s": write_s, "load_s": load_s, "pose_diff": worst}


def fixture_world_cloud(n=1200):
    """tools/make_reference_fixture.py's world (seed 1234): two walls and a
    floor, the cloud tests/fixtures/reference_map.pbstream was made from."""
    rng = np.random.default_rng(1234)
    wall_a = np.stack([np.full(n // 3, 8.0), rng.uniform(-6, 6, n // 3), rng.uniform(-2, 2, n // 3)], -1)
    wall_b = np.stack([rng.uniform(-6, 6, n // 3), np.full(n // 3, -7.0), rng.uniform(-2, 2, n // 3)], -1)
    m = n - 2 * (n // 3)
    floor = np.stack([rng.uniform(-6, 6, m), rng.uniform(-6, 6, m), np.full(m, -2.0)], -1)
    return np.concatenate([wall_a, wall_b, floor]).astype(np.float32)


def check_fixture(dev):
    """Phase 10 (c): localize a live revisit against the reference-schema
    fixture on the card (tests/test_pbstream.py:232-290)."""
    from dliom_tpu_torch.backend.pose_graph import NodeRecord
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.map_builder import map_builder_from_state
    from dliom_tpu_torch.mapping import probability as pv
    from dliom_tpu_torch.mapping.grid import cell_index, make_grid, set_cells
    from dliom_tpu_torch.mapping.submap import grid_specs
    from dliom_tpu_torch.ops.rotational_histogram import compute_histogram
    from dliom_tpu_torch.transform.rigid import Rigid3

    cfg = load_config("basic", FIXTURE_OVERRIDES)
    t0 = time.perf_counter()
    builder = map_builder_from_state(FIXTURE, cfg, pure_localization=True, device=dev)
    pg = builder.pose_graph
    frozen = pg.submaps[0].trajectory_id
    check(pg.submaps[0].frozen and pg.submaps[0].finished and pg.trajectory_states()[frozen] == "FROZEN"
          and int(pg.submaps[0].high.count) > 0, "phase 10: the fixture loads frozen with its grids")
    world = fixture_world_cloud()
    wrong = Rigid3(np.asarray([1.0, 0.0, 0.0, 0.0]), np.asarray([3.0, -2.0, 0.0]))
    s1 = pg.add_submap(wrong, trajectory_id=0)
    pts = torch.from_numpy(world).to(dev)
    mask = torch.ones(len(world), dtype=torch.bool, device=dev)
    node = NodeRecord(time=0.0, local_pose=wrong, gravity_alignment=np.asarray([1.0, 0, 0, 0], np.float32),
                      high_points=world, high_mask=np.ones(len(world), bool), low_points=world,
                      low_mask=np.ones(len(world), bool),
                      histogram=compute_histogram(pts, mask, cfg.trajectory_builder.rotational_histogram_size)
                      .cpu().numpy(), submap_ids=(), trajectory_id=0)
    value = pv.probability_to_value(torch.tensor(0.9))
    grids = [set_cells(make_grid(spec, dev), cell_index(pts, spec.resolution), value, spec)
             for spec in grid_specs(cfg.trajectory_builder.submaps)]
    pg.add_node(node, (s1,), newly_finished_submap_id=s1, finished_grids=tuple(grids))
    inter = [c for c in pg.constraints if c.tag == "INTER"]
    check(inter and pg.trajectories_connected(frozen, 0), "phase 10: the revisit found an INTER constraint")
    pg.run_final_optimization()
    err = float(np.linalg.norm(pg.nodes[-1].global_pose.translation))
    origin = float(np.abs(pg.submaps[0].global_pose.translation).max())
    seconds = time.perf_counter() - t0
    check(err < 0.4 and origin <= 1e-6, f"phase 10: live node {err:.3f} m from the origin, fixture map "
          f"moved {origin:.2e}")
    print(f"fixture: {len(inter)} INTER constraint(s) (score {inter[0].score:.3f}); the live node from "
          f"(3, -2, 0) lands {err:.4f} m from the fixture's origin; {seconds:.2f} s", flush=True)
    return {"error_m": err, "seconds": seconds}


def check_runner(ac, dev, tmp):
    """Phase 10 (d): `runner.offline.run` over the synthetic corkscrew."""
    import os

    from dliom_tpu_torch.map_builder import map_builder_from_state
    from dliom_tpu_torch.runner import offline

    files = {k: os.path.join(tmp, v) for k, v in (("csv", "traj.csv"), ("state", "state.npz"),
                                                  ("pbstream", "runner.pbstream"))}
    args = offline.build_parser().parse_args(
        ["--dataset", "synthetic", "--device", dev.type, "--output-csv", files["csv"],
         "--output-state", files["state"], "--output-pbstream", files["pbstream"]])
    steps = count_steps()
    from dliom_tpu_torch.imu import window_optimizer as wo

    ac.LAUNCHES = wo.LAUNCHES = 0  # the runner's main path: zero the launch counts
    report = offline.run(args)
    launches = ac.LAUNCHES
    K3_BY_PATH["runner"] = wo.LAUNCHES
    steps["restore"]()
    counts = check_graph_counts("runner", graphs_counts(steps), steps["n"])
    check(K3_BY_PATH["runner"] == steps["n"],
          f"phase 10: runner: K3 {K3_BY_PATH['runner']} launches for {steps['n']} steps")
    missing = [k for k in RUNNER_REPORT_KEYS if k not in report]
    check(not missing, f"phase 10: runner report lacks {missing}")
    check(report["num_nodes"] > 0 and all(os.path.getsize(f) > 0 for f in files.values()),
          "phase 10: runner nodes and files")
    check(launches == steps["n"] > 0, f"phase 10: runner K2 {launches} launches for {steps['n']} steps")
    reloaded = map_builder_from_state(files["state"], offline.run_config(args), device=dev)
    check(len(reloaded.pose_graph.nodes) == report["num_nodes"], "phase 10: the runner's state reloads")
    print(f"runner: {report['num_scans']} scans, {steps['n']} stepped, {report['num_nodes']} nodes, "
          f"{report['num_submaps']} submaps in {report['wall_seconds']} s = {report['scans_per_sec']} "
          f"scans/s; ATE {report['ate_rmse_m']} m (aligned {report['ate_rmse_aligned_m']} m, before the "
          f"final optimization {report['pre_optimization_ate_rmse_m']} m); K2 {launches} launches; the "
          "state reloads", flush=True)
    return launches, {k: report[k] for k in ("num_scans", "num_nodes", "scans_per_sec", "wall_seconds",
                                             "ate_rmse_m", "ate_rmse_aligned_m")} | {"steps": steps["n"],
                                                                                     "compiled_step": counts}


def check_io(ga, ac, dev, tmp):
    """Phase 10: save, resume and reload a map on the card. Also returns
    what phase 12 resumes from: the checkpoint file in `tmp`, builder B and
    the scans B took after it."""
    a, cfg, launches, ckpt, resumed = check_checkpoint(ga, ac, dev, tmp)
    pbstream = check_pbstream(a, cfg, dev, tmp)
    fixture = check_fixture(dev)
    runner_k2, runner = check_runner(ac, dev, tmp)
    return launches, runner_k2, {"checkpoint": ckpt, "pbstream": pbstream, "fixture": fixture,
                                 "runner": runner}, resumed


def batched_config(overrides, lanes, capacities, **submaps):
    """The engine config at `lanes` sequences: K1's per-call `capacities`
    times the lanes (one call holds every lane's groups)."""
    from dliom_tpu_torch.common.config import load_config

    caps = {k: lanes * v for k, v in capacities.items()}
    return load_config("basic", overrides).override({"trajectory_builder": {"submaps": {**caps, **submaps}}})


def batched_scaling(ga, ac, dev, single_rate):
    """Phase 11 (a): the bench config at B = BATCHES, each lane on its own
    world. Per B: BATCH_WARMUP steps, then BATCH_TIMED timed steps (K1 and
    K2 counted); at the smallest and largest B, device kernels and their
    time per step from torch.profiler (the card's activity only) after a
    warm-up cycle (tools/torch_batch_scaling.py --profile prints the spans
    at every B). Returns (rows, K1 launches, K2 launches)."""
    from dliom_tpu_torch.imu import window_optimizer as wo
    from dliom_tpu_torch.parallel.batch import make_batched_lio_state, make_batched_lio_step

    import gc

    rows, k1, k2 = {}, 0, 0
    all_lanes = lane_scans(dev, max(BATCHES), 10)
    for b in BATCHES:
        t_b = time.perf_counter()
        cfg = batched_config(BENCH_OVERRIDES, b, SPAWN_CAPACITIES).trajectory_builder
        scans = [type(s)(*(x[:b] for x in s)) for s in all_lanes]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        box = {"state": make_batched_lio_state(cfg, b, dev), "i": 0, "results": []}
        step = make_batched_lio_step(cfg, b)

        def run(n):
            for _ in range(n):
                box["state"], res = step(box["state"], scans[box["i"] % len(scans)])
                box["results"].append(tree_clone(res))  # the next replay rewrites the graph's result
                box["i"] += 1

        run(BATCH_WARMUP)
        torch.cuda.synchronize()
        ga.LAUNCHES = 0  # the batched main path starts: zero the launch counts
        ac.LAUNCHES = wo.LAUNCHES = 0
        t0 = time.perf_counter()
        run(BATCH_TIMED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"grouped_apply": ga.LAUNCHES, "affine_chain": ac.LAUNCHES}
        k1, k2 = k1 + ga.LAUNCHES, k2 + ac.LAUNCHES
        K3_BY_PATH["batched"] = K3_BY_PATH.get("batched", 0) + wo.LAUNCHES
        check(wo.LAUNCHES == BATCH_TIMED, f"phase 11: B={b} K3 {wo.LAUNCHES} launches for {BATCH_TIMED} steps")
        check(launches == {"grouped_apply": 2 * BATCH_TIMED, "affine_chain": BATCH_TIMED},
              f"phase 11: B={b} launches {launches} for {BATCH_TIMED} steps (2 K1, 1 K2 per step)")
        counts = check_graph_counts(f"batched B={b}", step.counts(), BATCH_WARMUP + BATCH_TIMED)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        t_prof = time.perf_counter()
        per_step = idle = None
        if b in (BATCHES[0], BATCHES[-1]):
            prof, prof_wall = warm_profile([lambda: run(BATCH_COUNTED), lambda: run(BATCH_COUNTED)],
                                           host=False)
            events = prof.events()
            busy, _ = card_busy_ms(events)
            per_step = len(device_events(events)) / BATCH_COUNTED
            check(per_step > 0, f"phase 11: B={b}: the profiler saw no device kernels")
            idle = 1 - busy / prof_wall
            del prof, events
        state = box["state"]
        sm = state.frontend.submaps
        drops = {"brick": int(sm.high_brick.dropped.sum()), "low_brick": int(sm.low_brick.dropped.sum()),
                 "dense": int(sm.dense_dropped.sum())}
        for k, r in enumerate(box["results"]):
            pose = r.scan.local_pose
            check(bool(torch.isfinite(pose.translation).all() and torch.isfinite(pose.rotation).all()),
                  f"phase 11: B={b} step {k} poses finite")
            check(not bool(r.failed.any()), f"phase 11: B={b} step {k} failed")
        check(int(state.failures.sum()) == 0, f"phase 11: B={b} no failure resets")
        check(not any(drops.values()), f"phase 11: B={b} dropped grid updates {drops}")
        rows[b] = {"aggregate_scans_per_s": b * BATCH_TIMED / wall, "per_seq_scans_per_s": BATCH_TIMED / wall,
                   "device_kernels_per_step": per_step, "idle_share": idle, "peak_mem_mib": peak,
                   "compiled_step": counts}
        r = rows[b]
        profiled = (f"{per_step:.0f} device kernels per step, card idle {idle:.3f}" if per_step is not None
                    else "kernels not counted")
        print(f"batched B={b}: {r['aggregate_scans_per_s']:.3f} scans/s aggregate, "
              f"{r['per_seq_scans_per_s']:.3f} per sequence (phase 5 single sequence {single_rate:.3f}); "
              f"{profiled}; K1 and K2 per step {launches['grouped_apply'] / BATCH_TIMED:.0f} and "
              f"{launches['affine_chain'] / BATCH_TIMED:.0f}; peak device memory {peak:.0f} MiB above the "
              f"{held / 2**20:.0f} MiB held before; drops {drops}; {time.perf_counter() - t_b:.1f} s "
              f"({time.perf_counter() - t_prof:.1f} s counting kernels)", flush=True)
        del box, state, sm, scans
    lo, hi = rows[BATCHES[0]]["device_kernels_per_step"], rows[BATCHES[-1]]["device_kernels_per_step"]
    check(hi <= BATCH_LAUNCH_RATIO * lo, f"phase 11: {hi:.0f} kernels per step at B={BATCHES[-1]} over "
          f"{BATCH_LAUNCH_RATIO} x {lo:.0f} at B={BATCHES[0]}")
    return rows, k1, k2


def batched_lanes(dev):
    """Phase 11 (b): B = 2 at the bench config (num_range_data cut so that
    spawns and a slot recycle happen; lane 1's first scan is empty, so the
    lanes spawn on different steps). On every step each lane's pose against
    `lio_step` from that lane's own pre-step state and input on the card,
    and the flat 2B-slot insert against each lane's own 2-slot insert of
    the same InsertionBatch on a copy of its banks, bit for bit."""
    from dliom_tpu_torch.frontend.lio import LioScanInput, lio_step
    from dliom_tpu_torch.mapping.brick_grid import BrickBank
    from dliom_tpu_torch.mapping.submap import InsertionBatch, write_insertion_batch
    from dliom_tpu_torch.parallel import batch as pb

    lanes = 2
    cfg = batched_config(BENCH_OVERRIDES, lanes, SPAWN_CAPACITIES,
                         num_range_data=LANES_RANGE_DATA).trajectory_builder
    state = pb.make_batched_lio_state(cfg, lanes, dev)
    worst, spawns, compared = 0.0, {b: [] for b in range(lanes)}, 0
    for k, inp in enumerate(lane_scans(dev, lanes, LANES_STEPS, empty_first=(1,))):
        pre = [pb.lane_state(cfg, state, b) for b in range(lanes)]
        state = pb.clear_spawned_slots(cfg, state)
        state, res = pb.lio_lanes(state, inp, cfg)
        sm = state.frontend.submaps
        before = sm._replace(high_brick=BrickBank(*(x.clone() for x in sm.high_brick)),
                             low_brick=BrickBank(*(x.clone() for x in sm.low_brick)))
        sm = pb.write_flat_insertion(cfg, sm, res.scan.insertion_batch)
        state = state._replace(frontend=state.frontend._replace(submaps=sm))
        drops = {}
        for b in range(lanes):
            _, one = lio_step(pre[b], LioScanInput(*(x[b] for x in inp)), cfg)
            d = max(float((res.scan.local_pose.translation[b] - one.scan.local_pose.translation).abs().max()),
                    float((res.scan.local_pose.rotation[b] - one.scan.local_pose.rotation).abs().max()))
            worst = max(worst, d)
            check(d <= POSE_ATOL, f"phase 11: step {k} lane {b}: batched vs single pose {d:.3e} > {POSE_ATOL}")
            check(bool(res.scan.inserted[b]) == bool(one.scan.inserted), f"phase 11: step {k} lane {b} inserted")
            if int(res.scan.finished_submap[b]) >= 0:
                spawns[b].append(k)
            own = pb.lane_banks(cfg, before, b)
            out = write_insertion_batch(own["high_values"], own["low_values"], own["high_brick"],
                                        InsertionBatch(*(x[b] for x in res.scan.insertion_batch)),
                                        cfg.submaps, low_brick=own["low_brick"])
            flat = pb.lane_banks(cfg, sm, b)
            for name in ("high_brick", "low_brick"):
                for f in ("directory", "pool", "counts", "group_of_slot", "epochs"):
                    check(torch.equal(getattr(out[name], f), getattr(flat[name], f)),
                          f"phase 11: step {k} lane {b} {name}.{f}: flat insert vs the lane's own")
                drops[name] = drops.get(name, 0) + int(out[name].dropped.sum())
            compared += 1
        for name in ("high_brick", "low_brick"):
            got = int(getattr(sm, name).dropped.sum()) - int(getattr(before, name).dropped.sum())
            check(got == drops[name] == 0, f"phase 11: step {k} {name} dropped {got} vs lanes' {drops[name]}")
    created = state.frontend.submaps.num_created.tolist()
    check(all(spawns.values()) and spawns[0] != spawns[1] and min(created) >= 3,
          f"phase 11: lanes spawn on different steps {spawns} and recycle a slot ({created} created)")
    print(f"batched lanes: B={lanes}, {LANES_STEPS} steps, spawns {spawns}, submaps created {created}: every "
          f"step's poses within {worst:.3e} of the lanes' own lio_step (tolerance {POSE_ATOL}); {compared} flat "
          "inserts bit-identical to the lanes' own", flush=True)
    return {"steps": LANES_STEPS, "spawns": spawns, "pose_diff": worst, "inserts_compared": compared}


def batched_held(ga, ac, dev, tag, cfg, lanes, steps, dense, finish=False):
    """Phase 11 (c) and (d): `steps` compiled batched steps at B = `lanes`
    from a fresh state, each held against the eager batched step from the
    same pre-step state (`graph_vs_eager`, `check_held`), across every
    lane's spawn (and, with `finish`, a submap's finish). With `dense`,
    every call of K1's dense entry in that eager step is held against its
    plain version on a CPU copy of the same bank and keys, bit for bit,
    `dropped` included. Returns (launches, record)."""
    from dliom_tpu_torch.parallel.batch import batched_lio_body, make_batched_lio_state, make_batched_lio_step

    entry = ga.apply_grouped_updates
    calls, active = [], {"on": False}

    def held(pool, keys, **kw):
        if not active["on"]:
            return entry(pool, keys, **kw)
        before, keys_c = pool.to("cpu", copy=True), keys.cpu()
        pool, dropped = entry(pool, keys, **kw)
        want, want_dropped = ga.apply_grouped_updates_plain(before, keys_c, **kw)
        calls.append((torch.equal(pool.cpu(), want), int(dropped), int(want_dropped)))
        return pool, dropped

    state = make_batched_lio_state(cfg, lanes, dev)
    step, eager_body, compared = make_batched_lio_step(cfg, lanes), batched_lio_body(cfg, lanes), {}
    kind = "grouped_apply_dense" if dense else "grouped_apply"
    from dliom_tpu_torch.imu import window_optimizer as wo

    before = (ga.DENSE_LAUNCHES if dense else ga.LAUNCHES, ac.LAUNCHES, wo.LAUNCHES)
    ga.apply_grouped_updates = held
    try:
        for k, inp in enumerate(lane_scans(dev, lanes, steps)):
            pre = tree_clone(state)
            state, res = step(state, inp)

            def eager():
                active["on"] = True
                try:
                    return eager_body(pre, inp)
                finally:
                    active["on"] = False
            compared[k] = graph_vs_eager((state, res), without_launches(eager))
            compared[k]["spawned"] = bool((state.frontend.submaps.num_created
                                           > pre.frontend.submaps.num_created).any())
            compared[k]["finished"] = bool((res.scan.finished_submap >= 0).any())
    finally:
        ga.apply_grouped_updates = entry
    launches = {kind: (ga.DENSE_LAUNCHES if dense else ga.LAUNCHES) - before[0],
                "affine_chain": ac.LAUNCHES - before[1]}
    k3 = wo.LAUNCHES - before[2]
    K3_BY_PATH["batched"] = K3_BY_PATH.get("batched", 0) + k3
    check(k3 == steps, f"phase 11: {tag}: K3 {k3} launches over {steps} compiled steps")
    check(launches == {kind: 2 * steps, "affine_chain": steps},
          f"phase 11: {tag} launched {launches} over {steps} compiled steps")
    held_steps = check_held(tag, compared)
    counts = check_graph_counts(tag, step.counts(), steps)
    sm = state.frontend.submaps
    drops = int(sm.dense_dropped.sum()) + sum(int(b.dropped.sum()) for b in (sm.high_brick, sm.low_brick)
                                             if b is not None)
    spawn = [k for k, h in compared.items() if h["spawned"]]
    finished = [k for k, h in compared.items() if h["finished"]]
    check(bool((sm.num_created >= 2).all()) and (finished or not finish) and drops == 0,
          f"phase 11: {tag}: every lane spawned (at steps {spawn}), submaps finished at steps {finished}, "
          f"drops {drops}")
    if dense:
        check(len(calls) == 2 * steps, f"phase 11: {len(calls)} K1 dense calls for {steps} steps")
        check(all(eq and d == w == 0 for eq, d, w in calls), f"phase 11: K1 dense calls vs plain {calls}")
    shown = (f"{len(calls)} K1 dense calls of the eager steps (2 per step) bit-identical to plain on a CPU "
             f"copy of {sm.high_values.numel()} + {sm.low_values.numel()} cells" if dense
             else "K1 brick 2 launches per step")
    print(f"{tag}: B={lanes}, {steps} compiled steps across every lane's spawn (at steps {spawn}; submaps "
          f"finished at steps {finished}), each held against the eager step: {shown}", flush=True)
    return launches, {"lanes": lanes, "steps": steps, "k1_dense_calls": len(calls), "spawn_steps": spawn,
                      "finish_steps": finished,
                      "graph_vs_eager": held_steps, "compiled_step": counts}


def batched_dense(ga, ac, dev):
    """Phase 11 (c): bench_e2e's dense grids at B = DENSE_LANES across a
    spawn, through the compiled batched step (`batched_held`, K1's dense
    entry held against plain)."""
    cfg = batched_config(E2E_OVERRIDES, DENSE_LANES,
                         {"dense_apply_groups": E2E_OVERRIDES["trajectory_builder"]["submaps"]["dense_apply_groups"]},
                         num_range_data=DENSE_LANES_RANGE_DATA).trajectory_builder
    return batched_held(ga, ac, dev, "batched dense", cfg, DENSE_LANES, DENSE_LANES_STEPS, dense=True)


def batched_brick(ga, ac, dev):
    """Phase 11 (d): (a)'s bench config (brick grids) at the largest B
    across a spawn, num_range_data cut as (b)'s, through the compiled
    batched step (`batched_held`)."""
    lanes = max(BATCHES)
    cfg = batched_config(BENCH_OVERRIDES, lanes, SPAWN_CAPACITIES,
                         num_range_data=LANES_RANGE_DATA).trajectory_builder
    return batched_held(ga, ac, dev, "batched brick", cfg, lanes, BRICK_LANES_STEPS, dense=False, finish=True)


def check_batched(ga, ac, dev, single_rate):
    """Phase 11: batched LIO on the card."""
    t0 = time.perf_counter()
    rows, k1, k2 = batched_scaling(ga, ac, dev, single_rate)
    t1 = time.perf_counter()
    lanes = batched_lanes(dev)
    t2 = time.perf_counter()
    dense_launches, dense = batched_dense(ga, ac, dev)
    t3 = time.perf_counter()
    brick_launches, brick = batched_brick(ga, ac, dev)
    seconds = time.perf_counter() - t0
    print(f"phase 11: {seconds:.1f} s (aim {PHASE11_AIM_S:.0f} s; (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
          f"(c) {t3 - t2:.1f}, (d) {t0 + seconds - t3:.1f})", flush=True)
    return ({"grouped_apply": k1 + brick_launches["grouped_apply"],
             "affine_chain": k2 + dense_launches["affine_chain"] + brick_launches["affine_chain"],
             "grouped_apply_dense": dense_launches["grouped_apply_dense"]},
            {"scaling": rows, "lanes": lanes, "dense": dense, "brick": brick, "seconds": seconds})


def timed_host_ms(fn, repeats=REPEATS):
    """Median host-clock time in ms of fn() (host work only)."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def check_cloud(ga, ac, dev, resumed, tmp):
    """Phase 12: builder C restored from phase 10's checkpoint behind the
    port's MapBuilderServer, fed B's next scans by the port's uploader;
    C against B bit for bit, then the queries over the wire against the
    same calls in-process, see the module docstring."""
    import os

    from dliom_tpu_torch.cloud import LocalTrajectoryUploader, MapBuilderServer, MapBuilderStub, wire
    from dliom_tpu_torch.io.assets_writer import (aggregate_point_cloud, snapshot_node_clouds, voxel_dedup,
                                                  xray_image)
    from dliom_tpu_torch.io.serialization import load_state, state_leaves
    from dliom_tpu_torch.map_builder import map_builder_from_checkpoint

    t_phase = time.perf_counter()
    cfg, b, scans = resumed["cfg"], resumed["b"], resumed["scans"]
    c = map_builder_from_checkpoint(resumed["path"], cfg, pipeline_depth=1, device=dev)
    _, t, pts, ptimes, _ = scans[0]  # one range-data frame as the stub sends it
    frame = {"method": "add_range_data", "params": {"time": t, "points": np.asarray(pts, np.float32),
                                                    "trajectory_id": 0, "times": np.asarray(ptimes, np.float32)}}
    blob = wire.packb(frame)
    encode_ms = timed_host_ms(lambda: wire.packb(frame))
    decode_ms = timed_host_ms(lambda: wire.unpackb(blob))

    server = MapBuilderServer(c)
    server.start()
    stub = MapBuilderStub(*server.address)
    up = LocalTrajectoryUploader(*server.address, batch_size=64, flush_interval=0.01)
    steps = count_steps()
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.DENSE_LAUNCHES = 0  # the served builder's main path: zero the launch counts
    ac.LAUNCHES = wo.LAUNCHES = 0
    items = 0
    try:
        t0 = time.perf_counter()
        for imu, t, pts, ptimes, pose in scans:  # feed_with_sensors' order, trajectory 0 (not registered)
            for ti, acc, gyr in imu:
                up.add_imu_data(ti, acc, gyr)
            up.add_odometry_data(t, pose.rotation, pose.translation)
            up.add_range_data(t, pts, ptimes)
            up.add_fixed_frame_pose_data(t + 0.05, pose.translation)
            items += len(imu) + 3
        up.start()
        rtts = []  # ping round trips while the SLAM thread steps
        deadline = t0 + CLOUD_DEADLINE_S
        while (up.num_items_sent < items or server._queue.unfinished_tasks) and time.perf_counter() < deadline:
            p0 = time.perf_counter()
            stub.ping()
            rtts.append((time.perf_counter() - p0) * 1e3)
            time.sleep(0.05)
        check(up.num_items_sent == items and not server._queue.unfinished_tasks,
              f"phase 12: {up.num_items_sent} of {items} items acknowledged, "
              f"{server._queue.unfinished_tasks} queued after {CLOUD_DEADLINE_S:.0f} s")
        up.flush()
        with server._lock:  # the JAX server has no flush RPC; the port adds none
            c.flush()
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t0
        launches = {"grouped_apply_dense": ga.DENSE_LAUNCHES, "affine_chain": ac.LAUNCHES}
        K3_BY_PATH["cloud"] = wo.LAUNCHES
        stepped = steps["n"]
        steps["restore"]()
        status = stub._call("status")
        check(status["num_errors"] == 0 and status["last_error"] == "",
              f"phase 12: the SLAM thread raised: {status}")
        check(up.dead_letters == [] and up.num_batches_sent >= 1,
              f"phase 12: uploader batches {up.num_batches_sent}, dead letters {len(up.dead_letters)}")
        check(stepped == len(scans), f"phase 12: C stepped {stepped} of {len(scans)} scans")
        cloud_counts = check_graph_counts("cloud", c.step_counts(), stepped)
        check(launches["grouped_apply_dense"] == 2 * stepped and launches["affine_chain"] == stepped,
              f"phase 12: C launches {launches} for {stepped} steps")
        check(K3_BY_PATH["cloud"] == stepped,
              f"phase 12: C: K3 {K3_BY_PATH['cloud']} launches for {stepped} steps")

        # C against B: one checkpoint, one input, one card
        lb, lc = list(state_leaves(b.trajectory(0)._lio)), list(state_leaves(c.trajectory(0)._lio))
        check([p for p, _ in lb] == [p for p, _ in lc], "phase 12: the same LioState fields")
        differ = [(p, x.dtype) for (p, x), (_, y) in zip(lb, lc) if not torch.equal(x, y)]
        check(not [p for p, dt in differ if not dt.is_floating_point],
              f"phase 12: C's integer state differs from B's: {differ}")
        pb, pc = b.pose_graph, c.pose_graph
        diff = graph_differences(pb, pc)
        worst = max((float(np.abs(np.asarray(getattr(x, k).translation) - np.asarray(getattr(y, k).translation)).max())
                     for x, y in zip(pb.nodes, pc.nodes) for k in ("local_pose", "global_pose")), default=0.0)
        exact = not differ and not diff
        check(exact or (len(pb.nodes) == len(pc.nodes) and worst <= POSE_ATOL
                        and not [d for d in diff if "grid" in d or "histogram" in d]),
              f"phase 12: C differs from B: LioState {differ[:5]}, graph {diff[:5]}, poses {worst:.3e}")
        print(f"cloud: C from phase 10's checkpoint behind MapBuilderServer, fed B's next {len(scans)} scans "
              f"({items} items) by LocalTrajectoryUploader in {up.num_batches_sent} batches: K1 dense "
              f"{launches['grouped_apply_dense']}, K2 {launches['affine_chain']} for {stepped} steps; status "
              f"{status['num_errors']} errors; C vs B "
              + ("bit-identical (every LioState tensor and the pose graph)" if exact else
                 f"NOT bit-identical: LioState {differ}, graph {diff[:6]}; node poses within {worst:.3e}"),
              flush=True)

        # queries over the wire against the same calls in-process
        times, trans, rots = stub.node_poses()
        nodes = c.optimized_node_poses()
        check(np.array_equal(times, [t for t, _ in nodes])
              and np.array_equal(trans, np.stack([p.translation for _, p in nodes]))
              and np.array_equal(rots, np.stack([p.rotation for _, p in nodes]))
              and trans.dtype == rots.dtype == np.float64, "phase 12: node_poses over the wire")
        check(np.array_equal(stub.submap_poses(), np.stack([p.translation for p in pc.submap_poses()])),
              "phase 12: submap_poses over the wire")
        sub, node, inter = stub.constraints()
        check(sub.tolist() == [x.submap_id for x in pc.constraints]
              and node.tolist() == [x.node_id for x in pc.constraints]
              and inter.tolist() == [x.tag == "INTER" for x in pc.constraints]
              and sub.dtype == node.dtype == np.int32 and inter.dtype == bool, "phase 12: constraints")
        first = next(i for i, x in enumerate(pc.submaps) if x.finished)
        r, want = stub.submap_query(first), c.submap_query(first)
        check(set(r) == set(want) and r["texture"].dtype == np.uint8
              and np.array_equal(r["texture"], want["texture"])
              and r["meters_per_pixel"] == want["meters_per_pixel"]
              and all(np.array_equal(r[k], want[k]) for k in want if k.endswith(("_q", "_t"))),
              f"phase 12: submap_query({first}) over the wire")
        img, origin, res = stub.occupancy_grid(0.25)
        pts = aggregate_point_cloud(snapshot=snapshot_node_clouds(pc))
        want_img, want_origin = xray_image(pts, 0.25)
        check(np.array_equal(img, want_img) and np.array_equal(origin, want_origin) and res == 0.25
              and img.dtype == np.uint8 and img.max() > 0, "phase 12: occupancy_grid(0.25)")
        cloud = stub.map_cloud(0.2)
        check(np.array_equal(cloud, voxel_dedup(pts, 0.2).astype(np.float32)) and len(cloud) > 0,
              "phase 12: map_cloud(0.2)")
        check(len(stub.metrics_text()) > 0, "phase 12: metrics")
        path = os.path.join(tmp, "served.npz")
        stub.write_state(path)
        loaded = load_state(path, cfg, device=dev)
        diff = graph_differences(pc, loaded, map_state=True)
        check(not diff, f"phase 12: write_state loads back into a different graph: {diff[:5]}")
        t0 = time.perf_counter()
        stub.finish_trajectory()
        finish_s = time.perf_counter() - t0
        status = stub._call("status")
        check(status["num_errors"] == 0 and pc.trajectory_states()[0] == "FINISHED",
              f"phase 12: finish_trajectory over the RPC: {status}")
        print(f"cloud: node_poses, submap_poses, constraints, submap_query({first}) (texture "
              f"{r['texture'].shape}), occupancy_grid(0.25) {img.shape}, map_cloud(0.2) {len(cloud)} points, "
              f"metrics and write_state ({os.path.getsize(path)} bytes, loads back equal) over the wire equal "
              f"to the same calls in-process; finish_trajectory answered in {finish_s:.2f} s", flush=True)
    finally:
        up.shutdown()
        stub.close()
        server.shutdown()  # the SLAM thread drains what was acknowledged, then stops
        for t in server._threads:
            t.join(CLOUD_DEADLINE_S)
    check(not any(t.is_alive() for t in server._threads) and not server._queue.unfinished_tasks,
          "phase 12: the server's queue drained and its threads stopped")
    seconds = time.perf_counter() - t_phase
    rtt = float(np.percentile(rtts, 50)) if rtts else float("nan")
    print(f"cloud: a range-data frame of {len(scans[0][2])} points is {len(blob)} bytes; the codec encodes it in "
          f"{encode_ms:.3f} ms and decodes it in {decode_ms:.3f} ms (host clock, median of {REPEATS}); served "
          f"{len(scans)} scans in {served_s:.2f} s against B's {resumed['b_seconds']:.2f} s direct (host clock, "
          f"noisy); ping round trip p50 {rtt:.2f} ms over {len(rtts)} pings while C stepped", flush=True)
    print(f"phase 12: {seconds:.1f} s (aim {PHASE12_AIM_S:.0f} s)", flush=True)
    return launches, {"frame_bytes": len(blob), "encode_ms": encode_ms, "decode_ms": decode_ms,
                      "served_s": served_s, "direct_s": resumed["b_seconds"], "ping_p50_ms": rtt,
                      "pings": len(rtts), "finish_s": finish_s, "bit_identical": exact, "pose_diff": worst,
                      "batches": up.num_batches_sent, "seconds": seconds, "compiled_step": cloud_counts}


def check_loop_recall(ga, ac, dev):
    """Phase 13 (a): tools/torch_loop_recall.py's trials on the card, trial
    LOOP_TRIAL_SEEDS[0] again on the CPU, and tools/torch_loop_debug.py's
    score_at_pose of its revisit node on both."""
    import torch_loop_debug as ld
    import torch_loop_recall as lr

    from dliom_tpu_torch.transform.rigid import Rigid3

    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.LAUNCHES = ga.DENSE_LAUNCHES = ac.LAUNCHES = wo.LAUNCHES = 0
    trials, card = [], {}
    for seed in LOOP_TRIAL_SEEDS:
        keep = {}
        t0 = time.perf_counter()
        r = lr.run_trial(seed, device=dev, keep=keep)
        torch.cuda.synchronize()
        trials.append(dict(r, seed=seed, seconds=time.perf_counter() - t0, programs=keep["pg"].graph_counts()))
        card = card or keep
        check(r["recall"] == 1.0 and r["closed"] == 1.0 and r["false_constraints"] == 0,
              f"phase 13: loop-recall trial {seed} on the card: {r}")
    launches = (ga.LAUNCHES, ga.DENSE_LAUNCHES, ac.LAUNCHES, wo.LAUNCHES)
    check(launches == (0, 0, 0, 0), f"phase 13: the loop-recall trials launched K1, K1 dense, K2, K3 {launches}")
    print("loop recall: " + "; ".join(
        f"trial {t['seed']} recall {t['recall']:.0f} precision {t['precision']:.3f} closed {t['closed']:.0f} "
        f"false INTER {t['false_constraints']} in {t['seconds']:.2f} s" for t in trials), flush=True)
    # each trial's pose graph owns its programs: it warms up and captures
    # each, and replays those it calls again (a submap's grids and image)
    print("loop recall: each trial's compiled programs (steps = warm-ups + replays; captures): " + " | ".join(
        f"trial {t['seed']}: " + ", ".join(f"{k} {v['steps']} = {v['warmups']} + {v['replays']}; {v['captures']}"
                                           for k, v in t["programs"].items()) for t in trials), flush=True)
    for t in trials:
        p = t["programs"]
        check(all(p.get(k, {}).get("captures", 0) >= 1 for k in ("decompress", "project", "propose", "search_initial"))
              and all(p[k]["replays"] >= 1 for k in ("decompress", "project")),
              f"phase 13: loop-recall trial {t['seed']} captured every search program and replayed the "
              f"decompression and the projection: {p}")

    cpu = {}
    t0 = time.perf_counter()
    lr.run_trial(LOOP_TRIAL_SEEDS[0], device="cpu", keep=cpu)
    cpu_s = time.perf_counter() - t0

    def inter(keep):
        return [c for c in keep["pg"].constraints if c.tag == "INTER"]

    a, b = inter(card), inter(cpu)
    check(set(card["proposals"]) == set(cpu["proposals"]) and [c.submap_id for c in a] == [c.submap_id for c in b],
          f"phase 13: trial {LOOP_TRIAL_SEEDS[0]} card vs CPU: proposals {sorted(card['proposals'])} vs "
          f"{sorted(cpu['proposals'])}, INTER submaps {[c.submap_id for c in a]} vs {[c.submap_id for c in b]}")
    dt = max(float(np.abs(np.asarray(x.relative.translation, np.float64)
                          - np.asarray(y.relative.translation, np.float64)).max()) for x, y in zip(a, b))
    dq = [np.asarray(x.relative.rotation, np.float64) * np.asarray(y.relative.rotation, np.float64) for x, y in zip(a, b)]
    dr = max(2.0 * float(np.arccos(min(1.0, abs(float(q.sum()))))) for q in dq)
    print(f"loop recall: trial {LOOP_TRIAL_SEEDS[0]} on the CPU ({cpu_s:.2f} s): proposals "
          f"{sorted(cpu['proposals'])} and INTER submaps {[c.submap_id for c in b]} as on the card; INTER relative "
          f"pose card vs CPU {dt:.3e} m, {dr:.3e} rad (tolerance {LOOP_REL_ATOL})", flush=True)
    check(dt <= LOOP_REL_ATOL and dr <= LOOP_REL_ATOL,
          f"phase 13: trial {LOOP_TRIAL_SEEDS[0]} INTER relative pose card vs CPU {dt:.3e} m, {dr:.3e} rad")

    # the revisit node sees place 0's cloud from place 0: its true pose in
    # submap 0's frame is the identity
    rel = Rigid3(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), np.zeros(3, np.float32))
    scores = [ld.score_at_pose(k["pg"], 0, k["pg"].nodes[k["node_id"]], rel) for k in (card, cpu)]
    worst = max(abs(scores[0][k] - scores[1][k]) for k in ld.SCORE_KEYS)
    print("loop debug: score_at_pose of the revisit node at its true pose on submap 0, card "
          + ", ".join(f"{k} {v:.6f}" for k, v in scores[0].items())
          + f"; largest difference from the CPU {worst:.3e} (tolerance {SCORE_ATOL})", flush=True)
    check(worst <= SCORE_ATOL, f"phase 13: score_at_pose card vs CPU differ by {worst:.3e}")
    return {"trials": trials, "cpu_seconds": cpu_s, "inter_t_diff_m": dt, "inter_r_diff_rad": dr,
            "scores": scores[0], "score_diff": worst}


def check_long_course(ga, ac, dev, tmp):
    """Phase 13 (b): tools/torch_long_course.py's generator at
    LONG_COURSE_LAPS, then its replay through the runner on the card at
    course_overrides() as shipped."""
    import os

    import torch_long_course as lc

    path = os.path.join(tmp, "long_course.npz")
    t0 = time.perf_counter()
    gt = lc.generate(path, LONG_COURSE_LAPS, LONG_COURSE_SEED)
    gen_s = time.perf_counter() - t0
    box = {}

    def on_builder(builder, report):
        pg = builder.pose_graph
        box.update(constraints=lc.evaluate_constraints(builder, gt), searches=len(pg.constraint_search_seconds),
                   finished=sum(s.finished for s in pg.submaps), results=builder.local_trajectory(0),
                   poses=builder.optimized_node_poses(),
                   drops=int(builder.trajectory(0)._lio.frontend.submaps.dense_dropped[0]))

    steps = count_steps()
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.LAUNCHES = ga.DENSE_LAUNCHES = ac.LAUNCHES = wo.LAUNCHES = 0  # the long course's main path starts
    report = lc.replay(path, dev, on_builder=on_builder)
    launches = {"grouped_apply": ga.LAUNCHES, "grouped_apply_dense": ga.DENSE_LAUNCHES, "affine_chain": ac.LAUNCHES}
    K3_BY_PATH["long_course"] = wo.LAUNCHES
    steps["restore"]()
    missing = [k for k in ("pre_optimization_ate_rmse_m", "ate_rmse_m", "pre_optimization_ate_rmse_aligned_m")
               if k not in report]
    check(not missing, f"phase 13: long-course report lacks {missing}")
    latency = report.get("constraint_search_latency_s", {"count": 0})
    check(latency["count"] == box["searches"],
          f"phase 13: {latency['count']} search latencies reported for {box['searches']} searches")
    check(report["pre_optimization_ate_rmse_aligned_m"] < 0.5,
          f"phase 13: long-course aligned ATE before the final optimization {report['pre_optimization_ate_rmse_aligned_m']}")
    keys = {"num_inter", "constraint_precision", "mean_constraint_t_err_m", "revisit_opportunities", "revisit_recall"}
    check(keys <= set(box["constraints"]), f"phase 13: evaluate_constraints lacks {keys - set(box['constraints'])}")
    stepped = len(box["results"])
    box["compiled_step"] = check_graph_counts("long course", graphs_counts(steps), steps["n"])
    check(launches["affine_chain"] == steps["n"] == stepped > 0,
          f"phase 13: long course K2 {launches['affine_chain']} launches for {steps['n']} steps, {stepped} results")
    check(K3_BY_PATH["long_course"] == steps["n"],
          f"phase 13: long course: K3 {K3_BY_PATH['long_course']} launches for {steps['n']} steps")
    check(launches["grouped_apply"] == launches["grouped_apply_dense"] == 0,
          f"phase 13: the long course's dense grids take the scatter insert, yet K1 ran {launches}")
    check(box["drops"] == 0 and not any(r["failed"] for r in box["results"]),
          f"phase 13: long course dropped {box['drops']} groups or reset")
    check(all(np.all(np.isfinite(p.translation)) and np.all(np.isfinite(p.rotation)) for _, p in box["poses"]),
          "phase 13: long-course node poses finite")
    print(f"long course: {LONG_COURSE_LAPS} laps (seed {LONG_COURSE_SEED}) generated in {gen_s:.1f} s; "
          f"{report['num_scans']} scans, {stepped} stepped, {report['num_nodes']} nodes, {report['num_submaps']} "
          f"submaps ({box['finished']} finished, {box['searches']} searches) in {report['wall_seconds']} s = "
          f"{report['scans_per_sec']} scans/s; ATE {report['ate_rmse_m']} m (aligned {report['ate_rmse_aligned_m']} "
          f"m; before the final optimization {report['pre_optimization_ate_rmse_m']} m, aligned "
          f"{report['pre_optimization_ate_rmse_aligned_m']} m); K2 {launches['affine_chain']} launches, K1 and K1 "
          f"dense 0 (scatter insert); constraints {json.dumps(box['constraints'])}", flush=True)
    return launches["affine_chain"], {k: report.get(k) for k in (
        "num_scans", "num_nodes", "num_submaps", "wall_seconds", "scans_per_sec", "ate_rmse_m", "ate_rmse_aligned_m",
        "pre_optimization_ate_rmse_m", "pre_optimization_ate_rmse_aligned_m", "constraint_search_latency_s")} | {
        "steps": stepped, "generate_seconds": gen_s, "finished_submaps": box["finished"],
        "compiled_step": box["compiled_step"], **box["constraints"]}


def check_loop_tools(ga, ac, dev, tmp):
    """Phase 13: the accuracy tools' paths on the card."""
    t0 = time.perf_counter()
    recall = check_loop_recall(ga, ac, dev)
    t1 = time.perf_counter()
    k2, course = check_long_course(ga, ac, dev, tmp)
    seconds = time.perf_counter() - t0
    print(f"phase 13: {seconds:.1f} s (aim {PHASE13_AIM_S:.0f} s; (a) {t1 - t0:.1f}, (b) {seconds - t1 + t0:.1f})",
          flush=True)
    return k2, {"loop_recall": recall, "long_course": course, "seconds": seconds}


# bench.py's frontend line: its keys, in its order (tests/test_torch_bench.py holds bench_torch's to them)
BENCH_FRONTEND_KEYS = ("metric", "value", "unit", "vs_baseline", "brick_groups_dropped",
                       "low_brick_groups_dropped", "dense_groups_dropped")
FLAGSHIP_WARM_MORE = 48  # phase 15 (b): at most this many scans past E2E_WARM, 8 at a time, for an INTER
FLAGSHIP_WINDOW_MAX = 3  # steps held across the first submap finish after the warm-up
PHASE15_AIM_S = 120.0


def check_bench_frontend(ga, ac, dev):
    """Phase 15 (a): `bench_torch.main` with BENCH_E2E=0, bench.py's
    frontend run on the port: its one JSON line, bench.py's keys, zero
    drops, and K1 twice and K2 once per scan of its WARMUP + MEASURE
    chunks (the warm-up's eager chunk, then the replays)."""
    import contextlib
    import io
    import os

    import bench_torch

    saved = {k: os.environ.get(k) for k in ("BENCH_E2E", "BENCH_E2E_FLAGSHIP")}
    os.environ["BENCH_E2E"] = "0"
    os.environ.pop("BENCH_E2E_FLAGSHIP", None)
    out = io.StringIO()
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.LAUNCHES = ga.DENSE_LAUNCHES = ac.LAUNCHES = wo.LAUNCHES = 0  # the main path starts: zero the launch counts
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            got = bench_torch.main(device=dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    launches = {"grouped_apply": ga.LAUNCHES, "grouped_apply_dense": ga.DENSE_LAUNCHES,
                "affine_chain": ac.LAUNCHES}
    K3_BY_PATH["bench_frontend"] = wo.LAUNCHES
    lines = out.getvalue().strip().splitlines()
    print(f"bench frontend: bench_torch.main() with BENCH_E2E=0 in {seconds:.1f} s printed: {lines}", flush=True)
    check(len(lines) == 1 and json.loads(lines[0]) == got, "bench frontend: one JSON line")
    check(tuple(got) == BENCH_FRONTEND_KEYS, f"bench frontend: keys {tuple(got)} are bench.py's")
    check(not any(got[k] for k in BENCH_FRONTEND_KEYS[4:]) and got["value"] > 0,
          f"bench frontend: zero drops and a rate: {got}")
    scans = (bench_torch.WARMUP + bench_torch.MEASURE) * bench_torch.CHUNK
    check(launches == {"grouped_apply": 2 * scans, "grouped_apply_dense": 0, "affine_chain": scans},
          f"bench frontend: launches {launches} for {scans} scans (K1 2, K2 1 a scan)")
    check(K3_BY_PATH["bench_frontend"] == scans,
          f"bench_frontend: K3 {K3_BY_PATH['bench_frontend']} launches for {scans} steps")
    return launches, {"line": got, "seconds": seconds, "scans": scans}


def record_flagship_window(builder, n_range_data):
    """Phase 15 (b)'s held window: from the first step after the warm-up
    (`rec["open"]` set by the caller) that can finish a submap (its
    pre-step back slot one insert short of `n_range_data`, two submaps
    made) to the step after the finish (the slot recycle), at most
    FLAGSHIP_WINDOW_MAX steps (a window the motion filter stretches past that
    is dropped, and the next opens): each replay held against the eager step from
    the same pre-step state (`hold_steps`), and every grouped brick K1 call
    of that eager step against its plain version on a CPU copy of the same
    bank and tables, bit for bit."""
    from dliom_tpu_torch.mapping.submap import back_slot
    from dliom_tpu_torch.ops import grouped_apply as ga

    rows = ga.apply_grouped_rows
    win = {"open": False, "start": None, "finished": None, "end": None, "calls": [], "restarts": 0}

    def select(k, rec):
        if not win["open"] or (win["end"] is not None and k >= win["end"]):
            return False
        if win["start"] is not None and win["finished"] is None and k >= win["start"] + FLAGSHIP_WINDOW_MAX:
            # the motion filter skipped the inserts that were due: drop this
            # window and open the next at the next step that can finish
            for j in range(win["start"], k):
                rec["held"].pop(j, None)
            win["calls"] = [c for c in win["calls"] if c["step"] < win["start"]]
            win["start"] = None
            win["restarts"] += 1
        if win["start"] is None:
            sm = builder.trajectory(0)._lio.frontend.submaps
            due = int(sm.num_created) >= 2 and int(sm.num_range_data[back_slot(sm)]) == n_range_data - 1
            if not due:
                return False
            win["start"] = k
        return k < win["start"] + FLAGSHIP_WINDOW_MAX

    def after(k, state, res, rec):
        if win["start"] is not None and win["finished"] is None and int(res.scan.finished_submap) >= 0:
            win["finished"], win["end"] = k, k + 2

    rec = hold_steps(select, after=after)

    def rows_recording(pool, r, starts, ends, keys, **kw):
        if not rec["eager"]:
            return rows(pool, r, starts, ends, keys, **kw)
        cpu = [x.to("cpu", copy=True) for x in (pool, r, starts, ends, keys)]
        before = cpu[0].clone()  # the plain version updates its bank in place
        fresh = kw.get("fresh")
        kw_cpu = dict(kw, fresh=None if fresh is None else fresh.cpu())
        out = rows(pool, r, starts, ends, keys, **kw)
        want = ga.apply_grouped_rows_plain(*cpu, **kw_cpu)
        win["calls"].append(dict(step=rec["n"], cells_per_group=kw["cells_per_group"], steps=int(r.numel()),
                                 records=int((ends - starts).clamp(min=0).sum()),
                                 equal=torch.equal(out.cpu(), want), changed=not torch.equal(want, before)))
        return out

    restore_steps = rec["restore"]

    def restore():
        restore_steps()
        ga.apply_grouped_rows = rows

    ga.apply_grouped_rows = rows_recording
    rec["restore"], rec["window"] = restore, win
    return rec


def check_flagship(ga, ac, dev):
    """Phase 15 (b): bench_torch's flagship config on the bench_e2e course
    cut as phase 8 cuts it; see the module docstring."""
    import bench_torch

    from dliom_tpu_torch.map_builder import MapBuilder

    cfg = bench_torch.e2e_config(flagship=True)
    sm_cfg = cfg.trajectory_builder.submaps
    check(sm_cfg.use_brick_grid and sm_cfg.use_brick_grid_low and sm_cfg.brick_apply_groups == 512
          and sm_cfg.low_brick_apply_groups == 192 and sm_cfg.high_resolution_extent == 448
          and sm_cfg.low_resolution_extent == 288, "flagship: bench.py's dual-brick grids and crops")
    n_warm = E2E_STATIC + E2E_WARM
    course = e2e_course(n_warm + FLAGSHIP_WARM_MORE + E2E_TIMED_MAX + 2 * E2E_PROFILED, radius=E2E_RADIUS)
    torch.cuda.reset_peak_memory_stats()
    builder = MapBuilder(cfg, use_background_threads=True, pipeline_depth=1, device=dev)
    pg = builder.pose_graph
    rec = record_flagship_window(builder, sm_cfg.num_range_data)
    backend_held = hold_backend_graphs()
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.LAUNCHES = ga.DENSE_LAUNCHES = ac.LAUNCHES = wo.LAUNCHES = 0  # the main path starts: zero the launch counts
    t_all = time.perf_counter()
    n_warm = warm_until_inter(builder, course, n_warm, E2E_STATIC + E2E_WARM + FLAGSHIP_WARM_MORE)
    warm_s = time.perf_counter() - t_all
    warm_phases = dict(sorted(pg.phase_seconds.items()))
    print(f"flagship: warm-up {n_warm} scans in {warm_s:.1f} s; nodes {len(pg.nodes)} submaps {len(pg.submaps)} "
          f"INTER {pg.num_inter_constraints()}; searches {len(pg.constraint_search_seconds)} "
          f"({sum(pg.constraint_search_seconds):.3f} s, the captures included); phase_seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in warm_phases.items()), flush=True)
    rec["window"]["open"] = True  # hold the first finish of the timed stretch
    timed, timed_s, solves = timed_stretch("flagship", builder, course, n_warm,
                                           lambda: rec["window"]["finished"] is None)
    lat = np.asarray(builder.local_slam_latency_seconds) * 1e3
    phases = dict(sorted(pg.phase_seconds.items()))
    search = np.asarray(pg.constraint_search_seconds)
    a = n_warm + timed
    busy, top, prof_wall = profile_course(builder, course[a:a + 2 * E2E_PROFILED])
    spa_before = pg.phase_seconds.get("spa", 0.0)
    builder.finish_trajectory()
    torch.cuda.synchronize()
    final_spa_s = pg.phase_seconds.get("spa", 0.0) - spa_before
    total_s = time.perf_counter() - t_all
    launches = {"grouped_apply": ga.LAUNCHES, "grouped_apply_dense": ga.DENSE_LAUNCHES,
                "affine_chain": ac.LAUNCHES}
    K3_BY_PATH["flagship"] = wo.LAUNCHES
    rec["restore"]()
    backend_held["restore"]()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    results = builder.local_trajectory(0)
    stepped = len(results)
    graph_counts = check_graph_counts("flagship", builder.step_counts(), stepped)
    backend_counts = check_backend_programs("flagship", builder)
    held_backend = check_backend_held("flagship", backend_held, ("decompress", "search_initial", "spa"))
    backend_graphs = measure_backend_graphs(pg)
    sm = builder.trajectory(0)._lio.frontend.submaps
    drops = {"brick": int(sm.high_brick.dropped[0]), "low_brick": int(sm.low_brick.dropped[0]),
             "dense": int(sm.dense_dropped[0])}
    capacity = (pg._compress_capacity, pg.low_compress_capacity)
    counts = [(sid, int(s.high.count), int(s.low.count)) for sid, s in enumerate(pg.submaps)
              if s.finished and s.high is not None]
    saturated = [c for c in counts if c[1] >= capacity[0] or c[2] >= capacity[1]]
    cached = [t for hit in pg._grid_cache.values() for t in (hit[0], hit[1], *hit[2].levels)]
    cache_mib = sum(t.numel() * t.element_size() for t in cached) / 2**20
    inter = pg.num_inter_constraints()
    inserted = sum(r["inserted"] for r in results)
    print(f"flagship: {len(course[:a + 2 * E2E_PROFILED])} scans ({E2E_STATIC} static, {n_warm - E2E_STATIC} "
          f"warm-up, {timed} timed, {E2E_PROFILED} + {E2E_PROFILED} profiled) in {total_s:.1f} s (warm-up "
          f"{warm_s:.1f} s); {stepped} stepped, {inserted} inserted; nodes {len(pg.nodes)} submaps "
          f"{len(pg.submaps)} constraints {len(pg.constraints)} INTER {inter}; final optimization "
          f"{final_spa_s:.2f} s; launches {launches}", flush=True)
    print(f"flagship: timed {timed} scans in {timed_s:.3f} s = {timed / timed_s:.3f} scans/s; scan latency "
          f"p50 {np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} ms; {len(search)} searches "
          f"(p50 {np.percentile(search, 50):.3f} s), {solves} periodic solves; phase_seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), flush=True)
    print(f"flagship: profiled {E2E_PROFILED} scans (card activity only): {prof_wall / E2E_PROFILED:.1f} ms/scan "
          f"wall, card busy {busy / E2E_PROFILED:.2f} ms/scan, idle share {1 - busy / prof_wall:.3f}; peak "
          f"device memory {peak_mib:.0f} MiB; the grid cache holds {len(pg._grid_cache)} decompressed submaps "
          f"(grids and pyramids) in {cache_mib:.1f} MiB", flush=True)
    for name, ms, n in top:
        print(f"flagship: profiled card time {ms:9.2f} ms in {n:6d} x {name[:90]}")
    print(f"flagship: drop gauges {drops} (bench.py's 512 / 192 apply groups, not raised: two active submaps "
          f"take every scan); captured cells of each finished submap (id, high, low) {counts} against "
          f"capacities {capacity}: {'saturated ' + str(saturated) if saturated else 'none saturated'}",
          flush=True)

    check_trajectory("flagship", builder, results)
    check(inter >= 1, "flagship: at least one INTER constraint")
    check(final_spa_s > 0.0, "flagship: the final optimization ran")
    check(stepped == rec["n"] > 0, f"flagship: {stepped} results for {rec['n']} steps")
    # the insert runs masked where the motion filter skips: the grouped
    # brick K1 on both grids every step
    check(launches == {"grouped_apply": 2 * stepped, "grouped_apply_dense": 0, "affine_chain": stepped},
          f"flagship: launches {launches} for {stepped} stepped scans (K1 brick 2, K2 1 a scan)")
    check(K3_BY_PATH["flagship"] == stepped,
          f"flagship: K3 {K3_BY_PATH['flagship']} launches for {stepped} steps")
    win = rec["window"]
    check(win["finished"] is not None, f"flagship: a submap finished in the held window {win}")
    held_steps = sorted(rec["held"])
    check(held_steps == list(range(win["start"], win["finished"] + 2))
          and len(held_steps) <= FLAGSHIP_WINDOW_MAX,
          f"flagship: held steps {held_steps} run from the window's start {win['start']} to the step after the "
          f"finish {win['finished']}")
    held = check_held("flagship", rec["held"])
    calls = win["calls"]
    check(len(calls) == 2 * len(held_steps), f"flagship: {len(calls)} brick K1 calls held for "
          f"{len(held_steps)} steps (high and low each)")
    for c in calls:
        check(c["equal"], f"flagship: grouped brick K1 on the card against plain at step {c['step']}: {c}")
    check(any(c["changed"] for c in calls), "flagship: the window's inserts wrote the banks")
    print(f"flagship: steps {held_steps} (submap finished at step {win['finished']}) held against the eager "
          f"step; its {len(calls)} grouped brick K1 calls bit-identical to plain on a CPU copy "
          f"({', '.join(str(c['records']) + ' records / ' + str(c['steps']) + ' steps' for c in calls)})",
          flush=True)
    return launches, {"scans_per_s": timed / timed_s, "timed_scans": timed, "timed_solves": solves,
                      "warm_up_scans": n_warm - E2E_STATIC, "compiled_step": graph_counts,
                      "graph_vs_eager": held, "p50_ms": float(np.percentile(lat, 50)),
                      "p99_ms": float(np.percentile(lat, 99)), "inter": inter, "nodes": len(pg.nodes),
                      "submaps": len(pg.submaps), "idle_share": 1 - busy / prof_wall, "phase_seconds": phases,
                      "final_spa_s": final_spa_s, "search_s": search.tolist(),
                      "warm_up_phase_seconds": warm_phases, "drops": drops, "captured_counts": counts,
                      "compress_capacity": capacity, "saturated": saturated, "peak_mib": peak_mib,
                      "grid_cache_mib": cache_mib, "grid_cache_submaps": len(pg._grid_cache),
                      "held_window": held_steps, "k1_brick_calls_held": len(calls),
                      "backend_counts": backend_counts, "backend_held": held_backend,
                      "backend_graphs": backend_graphs, "programs_mib": programs_memory(pg, "flagship"),
                      "seconds": total_s}


def check_bench(ga, ac, dev):
    """Phase 15: bench_torch.py on the card, (a) its frontend and (b) its
    flagship course, cut."""
    t0 = time.perf_counter()
    front_launches, front = check_bench_frontend(ga, ac, dev)
    t1 = time.perf_counter()
    gc.collect()
    flag_launches, flagship = check_flagship(ga, ac, dev)
    seconds = time.perf_counter() - t0
    print(f"phase 15: {seconds:.1f} s (aim {PHASE15_AIM_S:.0f} s; (a) {t1 - t0:.1f}, (b) {seconds - t1 + t0:.1f})",
          flush=True)
    return {"bench_frontend": front_launches, "flagship": flag_launches}, {
        "frontend": front, "flagship": flagship, "seconds": seconds}


# ----- phase 16: the mesh -----

MESH_SHARDS = 4  # shards of phase 16's mesh: distinct cards where there are that many, else on cuda:0
MESH_LANES = 2  # lanes per shard in (a)
MESH_WARMUP = 1
MESH_HELD = 3  # (a): replays held against each shard's eager step
MESH_TIMED = 6  # (a): steps timed, sharded and unsharded (lane_scans' ten poses end there)
MESH_SPA_ITERATIONS = 3  # (b): GN steps of each solve
MESH_SPA_CALLS = 3  # (b): compiled solves timed after the first (warm-ups and captures), each held
MESH_SPA_PERTURB = (0.05, 0.01)  # (b): normal noise (seed 0) on the node translations (m) and quaternions
MESH_SPA_F64_NOISE = ((0.005, 0.001), (0.02, 0.004), (0.1, 0.02))  # (b): spa_tolerance's premise held there too
MESH_SPA_RTOL = 3e-3  # (b), (d): `spa_tolerance`'s share of the solve's movement (derivation there)
MESH_SPA_ULPS = 4  # (b), (d): `spa_tolerance`'s float32 spacings of the largest pose component
MESH_SPA_MOVES = 1e-3  # (b): the solve must move a node by more than this (m)
MESH_BUILDER_SCANS = 64  # (d): scans of phase 8's course through MapBuilder(mesh=)
MESH_BUILDER_MORE = 32  # (d): at most this many more, 8 at a time, until the pool ran a search and a solve
MESH_BUILDER_RANGE_DATA = 4  # (d): submaps.num_range_data 16 -> 4, so submaps finish (and searches run) early
MESH_BUILDER_OPTIMIZE = 16  # (d): pose_graph.optimize_every_n_nodes 32 -> 16
MESH_FRONTEND_STEPS = 3  # (e): sharded_step's steps, each held shard by shard
MESH_FRONTEND_GROUPS = 64  # (e): dense_apply_groups, so that the insert runs K1's dense entry (0: scatter)
MESH_POSE_ATOL = 1e-6  # (c): a chunk's refined poses, split over the shards against one batch, per metre
# of the chunk's largest translation where that is over 1 m: the batched GN refinement of a piece
# rounds apart from that of the whole chunk in the last f32 bits, which scale with the translation
PHASE16_AIM_S = 60.0
MESH_INPUTS = {}  # phase 8's first with-initial search chunk and its final problem, for phase 16


def record_search_chunk(pg):
    """Keep the with-initial search chunks of the largest node count that
    `pg` runs (the target submap's cached grids, the host arrays and the
    packed result: none is rewritten later); `kept_search_chunk` picks
    phase 16 (c)'s from them."""
    search = pg._search
    kept = MESH_INPUTS["chunks"] = []

    def recorded(kind, hit, arrays):
        out = search(kind, hit, arrays)
        if kind == "search_initial":
            if kept and len(arrays[0]) > len(kept[0][1][0]):
                kept.clear()
            if not kept or len(arrays[0]) == len(kept[0][1][0]):
                kept.append((hit, arrays, out))
        return out

    pg._search = recorded


def kept_search_chunk():
    """Of the chunks `record_search_chunk` kept (all searches ended), the
    first that found a node, else the first; its grids copied to the host
    until phase 16."""
    chunks = MESH_INPUTS.pop("chunks", [])
    if chunks:
        hit, arrays, _ = next((c for c in chunks if bool((c[2][:, 0] > 0.5).any())), chunks[0])
        MESH_INPUTS["chunk"] = (tree_cpu(hit), arrays)


def phase_mesh():
    """Phase 16's mesh: MESH_SHARDS distinct cards, or as many shards on
    cuda:0 where there are fewer cards."""
    from dliom_tpu_torch.common.mesh import Mesh, make_mesh

    n = torch.cuda.device_count()
    return make_mesh(MESH_SHARDS) if n >= MESH_SHARDS else Mesh((torch.device("cuda", 0),) * MESH_SHARDS)


def sync_mesh(mesh):
    """The current stream of every card of the mesh synchronized (never the
    device: a pool thread may be capturing)."""
    for d in mesh.distinct_devices:
        torch.cuda.current_stream(d).synchronize()


def mesh_lio(ga, ac, mesh):
    """Phase 16 (a): `sharded_lio_step` at the bench config, MESH_LANES
    lanes a shard; see the module docstring."""
    from dliom_tpu_torch.common.mesh import shard_over_mesh
    from dliom_tpu_torch.parallel.batch import (
        batched_lio_body,
        make_batched_lio_state,
        make_batched_lio_step,
        make_sharded_lio_state,
        sharded_lio_step,
    )

    d = mesh.size
    batch = MESH_LANES * d
    cfg = batched_config(BENCH_OVERRIDES, MESH_LANES, SPAWN_CAPACITIES).trajectory_builder
    scans = lane_scans(mesh.first, batch, MESH_WARMUP + MESH_HELD + MESH_TIMED)
    sharded = [shard_over_mesh(s, mesh) for s in scans]
    states = make_sharded_lio_state(cfg, batch, mesh)
    step = sharded_lio_step(cfg, batch, mesh)
    body = batched_lio_body(cfg, MESH_LANES)
    held, results = {}, []
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.LAUNCHES = ga.DENSE_LAUNCHES = ac.LAUNCHES = wo.LAUNCHES = 0  # the mesh's main path starts: zero the launch counts
    t0 = time.perf_counter()
    states, res = step(states, sharded[0])
    sync_mesh(mesh)
    warm_s = time.perf_counter() - t0
    results.append(tree_clone(res))
    for k in range(1, 1 + MESH_HELD):
        pre = [tree_clone(st) for st in states]
        states, res = step(states, sharded[k])
        sync_mesh(mesh)
        for s, dev in enumerate(mesh.devices):
            with torch.cuda.device(dev):
                want = without_launches(lambda: body(pre[s], sharded[k][s]))
            held[(k, s)] = graph_vs_eager((states[s], res[s]), want)
        results.append(tree_clone(res))
    sync_mesh(mesh)
    t0 = time.perf_counter()
    for k in range(1 + MESH_HELD, len(sharded)):
        states, res = step(states, sharded[k])
    sync_mesh(mesh)
    mesh_s = time.perf_counter() - t0
    results.append(tree_clone(res))  # the last step's (no clone inside the timed window)
    launches = {"grouped_apply": ga.LAUNCHES, "grouped_apply_dense": ga.DENSE_LAUNCHES,
                "affine_chain": ac.LAUNCHES}
    K3_BY_PATH["mesh"] = wo.LAUNCHES
    n_steps = len(sharded)
    check(launches == {"grouped_apply": 2 * d * n_steps, "grouped_apply_dense": 0, "affine_chain": d * n_steps},
          f"phase 16: sharded launches {launches} for {n_steps} steps over {d} shards (K1 2, K2 1 a shard a step)")
    check(K3_BY_PATH["mesh"] == d * n_steps,
          f"mesh: K3 {K3_BY_PATH['mesh']} launches for {d * n_steps} steps")
    counts = step.counts()
    check(counts == {"steps": d * n_steps, "warmups": d, "captures": d, "replays": d * (n_steps - 1)},
          f"phase 16: sharded step counts {counts}")
    held_out = check_held("mesh", {f"{k}/{s}": h for (k, s), h in held.items()})
    drops = sum(int(b.dropped.sum()) for st in states for b in (st.frontend.submaps.high_brick,
                                                                 st.frontend.submaps.low_brick))
    check(drops == 0, f"phase 16: dropped grid updates {drops}")
    for k, r in enumerate(results):
        for s, rs in enumerate(r):
            check(bool(torch.isfinite(rs.scan.local_pose.translation).all()) and not bool(rs.failed.any()),
                  f"phase 16: step {k} shard {s}: finite poses, no failure")
            check(rs.scan.local_pose.translation.device == mesh.devices[s], f"phase 16: shard {s}'s results "
                  f"on {mesh.devices[s]}")

    # the unsharded batched step at the same B, on the first card
    from dliom_tpu_torch.common.mesh import gather

    one_cfg = batched_config(BENCH_OVERRIDES, batch, SPAWN_CAPACITIES).trajectory_builder
    one_state = make_batched_lio_state(one_cfg, batch, mesh.first)
    one_step = make_batched_lio_step(one_cfg, batch)
    one_state, _ = one_step(one_state, scans[0])
    for k in range(1, 1 + MESH_HELD):
        one_state, _ = one_step(one_state, scans[k])
    torch.cuda.synchronize(mesh.first)
    t0 = time.perf_counter()
    for k in range(1 + MESH_HELD, len(scans)):
        one_state, one_res = one_step(one_state, scans[k])
    torch.cuda.synchronize(mesh.first)
    one_s = time.perf_counter() - t0
    last = gather(results[-1], "cpu")
    one_pose = one_res.scan.local_pose.translation.cpu()
    lane_diff = float((last.scan.local_pose.translation - one_pose).abs().max())
    rate, one_rate = batch * MESH_TIMED / mesh_s, batch * MESH_TIMED / one_s
    print(f"mesh: sharded_lio_step, B={batch} over {d} shards ({MESH_LANES} lanes each), bench config: first "
          f"step (each shard's eager warm-up and capture) {warm_s:.2f} s; {MESH_TIMED} timed steps (host "
          f"clock, synchronized either side, nothing cloned) {rate:.3f} scans/s aggregate beside the unsharded batched step at B={batch} on {mesh.first} "
          f"{one_rate:.3f}; the last step's poses sharded vs unsharded differ by {lane_diff:.3e} m (free-running "
          f"since the warm-up); launches {launches}", flush=True)
    return launches, {"lanes": batch, "shards": d, "first_step_s": warm_s, "scans_per_s": rate,
                      "unsharded_scans_per_s": one_rate, "held": held_out, "compiled_step": counts,
                      "last_pose_vs_unsharded": lane_diff}


def spa_tolerance(moved, scale):
    """(b), (d): the gate between two float32 solves of one SPA problem
    that differ only in the order of their partial sums (sharded against
    unsharded, a replay against the eager solve): MESH_SPA_RTOL times the
    solve's largest node movement `moved` plus MESH_SPA_ULPS float32
    spacings of the largest pose component `scale` (m).

    Derivation. A float32 solve departs from the float64 solve of the
    same problem by its own rounding: each GN step's 64 Jacobi-
    preconditioned CG steps give an increment whose error grows with the
    increment (the conditioning of the normal equations times the unit
    roundoff), and each pose update rounds once to the pose's spacing. So
    |f32 - f64| <= r moved + k spacing(scale), and for two f32 solves
    |a - b| <= |a - f64| + |b - f64| <= 2 r moved + 2 k spacing(scale).
    Measured (PERF.md §6; `spa_f64_errors` prints it every run), on four
    of phase 8's final problems (7-8 submaps, 108-116 nodes, 219-242
    rows; 3 GN steps) with their node poses perturbed by (0.005, 0.001)
    to (0.1, 0.02): every f32 solve, sharded or not, came within 3.3e-5 to
    3.4e-4 of the movement (0.019 to 0.377 m) of the float64 solve, so r
    <= 3.4e-4 and 2 r = 6.8e-4; the problems' largest r spread by a
    factor of 5, and MESH_SPA_RTOL keeps a factor of 4.4 over 2 r. k = 2
    covers 3 pose roundings of half a spacing. The sharded and unsharded
    solves came 7.2e-7 to 2.9e-5 apart (at most 2.9e-4 of the movement);
    the compiled and eager solves 0. A lost or stale partial sum moves the
    poses by a share of the movement itself, far above the gate.
    `mesh_spa` checks the premise, each f32 solve within half the gate of
    the float64 solve."""
    return MESH_SPA_RTOL * moved + MESH_SPA_ULPS * float(np.spacing(np.float32(scale)))


def spa_problem(noise):
    """Phase 8's final pose-graph problem (host arrays, blocks) with its node
    poses perturbed by normal noise (seed 0) of `noise` (m, quaternion
    components): phase 8's final optimization solved it already."""
    host, n_sub, n_node, blocks = MESH_INPUTS["problem"]
    host = dict(host)
    rng = np.random.default_rng(0)
    t, q = host["node_t"].copy(), host["node_q"].copy()
    t[:n_node] += rng.normal(0.0, noise[0], (n_node, 3)).astype(t.dtype)
    q[:n_node] += rng.normal(0.0, noise[1], (n_node, 4)).astype(q.dtype)
    q[:n_node] /= np.linalg.norm(q[:n_node], axis=-1, keepdims=True)
    host["node_t"], host["node_q"] = t, q
    return host, n_sub, n_node, blocks


def spa_f64_errors(op, data, blocks, solves):
    """Each float32 solve's flat host poses in `solves` against a float64
    solve of the same problem (`data`, on its device): the largest
    difference of each."""
    from dliom_tpu_torch.backend import optimization as opt
    from dliom_tpu_torch.backend.pose_graph import _spa_settings

    d64 = opt.PoseGraphData(*(x.double() if x.is_floating_point() else x for x in data))
    ref = opt.solve(d64, iterations=MESH_SPA_ITERATIONS, **_spa_settings(op, blocks))
    ref = torch.cat([getattr(ref, f).reshape(-1) for f in ("submap_q", "submap_t", "node_q", "node_t",
                                                          "lm_positions")]).cpu().numpy()
    return {k: float(np.abs(v.astype(np.float64) - ref).max()) for k, v in solves.items()}


def mesh_spa(mesh):
    """Phase 16 (b): the SPA over the mesh on phase 8's final problem
    (`spa_problem`), its constraint rows dealt round the shards (row i to
    shard i % D, so every shard holds valid rows: the same problem, its
    rows in another order). The eager `solve(mesh=)` and the eager
    unsharded solve, a warm-up then one timed; the compiled solves through
    `PoseGraph._solve` (backend/pose_graph.py::_SpaPrograms: over the mesh,
    and a single shard without one), the first call of each (warm-ups and
    captures) timed apart, then MESH_SPA_CALLS calls timed, every call
    held against the eager solve of the same data and mesh; sharded
    against unsharded, eager and compiled, within `spa_tolerance`; the
    solve must move a node by more than MESH_SPA_MOVES; each f32 solve
    against a float64 solve of the same problem. ms a GN step on the host
    clock (a compiled call: the staging copies, MESH_SPA_ITERATIONS GN
    steps and the host read of the poses)."""
    from dliom_tpu_torch.backend import optimization as opt
    from dliom_tpu_torch.backend.pose_graph import PoseGraph, _spa_settings, spa_solve_eager
    from dliom_tpu_torch.common.config import load_config

    host, n_sub, n_node, blocks = spa_problem(MESH_SPA_PERTURB)
    rows = host["c_valid"].shape[0]
    dealt = np.argsort(np.arange(rows) % mesh.size, kind="stable")

    def dealt_rows(h):
        return dict(h, **{f: h[f][dealt] for f in opt._C_FIELDS})

    spread = dealt_rows(host)
    per = -(-rows // mesh.size)
    valid_per_shard = [int(spread["c_valid"][k * per:(k + 1) * per].sum()) for k in range(mesh.size)]
    cfg = load_config("basic", E2E_OVERRIDES)
    op = cfg.pose_graph.optimization_problem
    cases = {"unsharded": (None, host), "sharded": (mesh, spread)}
    data, eager, ms, first_ms, held, counts = {}, {}, {}, {}, {}, {}
    for name, (m, h) in cases.items():
        data[name] = opt.PoseGraphData(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.first)
                                          for k, v in h.items()})
        spa_solve_eager(op, data[name], MESH_SPA_ITERATIONS, blocks, m)  # warm-up
        sync_mesh(mesh)
        t0 = time.perf_counter()
        eager[name] = spa_solve_eager(op, data[name], MESH_SPA_ITERATIONS, blocks, m)
        sync_mesh(mesh)
        ms[f"eager_{name}"] = (time.perf_counter() - t0) * 1e3 / MESH_SPA_ITERATIONS
    moved = float((eager["unsharded"].node_t - data["unsharded"].node_t).abs().max())
    scale = max(float(np.abs(host[f]).max()) for f in ("submap_t", "node_t"))
    tol = spa_tolerance(moved, scale)
    flat, pgs = {}, {}
    for name, (m, h) in cases.items():
        pg = pgs[name] = PoseGraph(cfg.pose_graph, cfg.trajectory_builder, device=mesh.first, mesh=m)
        flat[f"eager_{name}"] = pg._read_poses(eager[name])
        sync_mesh(mesh)
        t0 = time.perf_counter()
        got = [pg._solve(h, MESH_SPA_ITERATIONS, blocks)]  # the warm-ups and captures
        first_ms[name] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(MESH_SPA_CALLS):
            got.append(pg._solve(h, MESH_SPA_ITERATIONS, blocks))  # replays; each ends in its host read
        ms[f"compiled_{name}"] = (time.perf_counter() - t0) * 1e3 / (MESH_SPA_CALLS * MESH_SPA_ITERATIONS)
        held[name] = max(float(np.abs(g - flat[f"eager_{name}"]).max()) for g in got)
        flat[f"compiled_{name}"] = got[-1]
        counts[name] = {k: v for k, v in pg.graph_counts().items() if k.startswith("spa")}
    diff = {"eager": float(np.abs(flat["eager_sharded"] - flat["eager_unsharded"]).max()),
            "compiled": float(np.abs(flat["compiled_sharded"] - flat["compiled_unsharded"]).max())}
    f64 = spa_f64_errors(op, data["unsharded"], blocks, flat)
    # spa_tolerance's premise at other movements, through the compiled programs (equal to eager above)
    premise = {}
    for noise in MESH_SPA_F64_NOISE:
        h = spa_problem(noise)[0]
        d = opt.PoseGraphData(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.first) for k, v in h.items()})
        solves = {name: pg._solve(h if name == "unsharded" else dealt_rows(h), MESH_SPA_ITERATIONS, blocks)
                  for name, pg in pgs.items()}
        e = spa_f64_errors(op, d, blocks, solves)
        s_, n_ = h["submap_q"].shape[0], h["node_q"].shape[0]
        at = 7 * s_ + 4 * n_  # the node translations in `_read_poses`' layout
        m_ = float(np.abs(solves["unsharded"][at:at + 3 * n_] - h["node_t"].reshape(-1)).max())
        premise[str(noise)] = {"moved": m_, "tolerance": spa_tolerance(m_, scale), "f64_error": e,
                               "sharded_vs_unsharded": float(np.abs(solves["sharded"] - solves["unsharded"]).max())}
    del pgs
    n_c = int(host["c_valid"].sum())
    print(f"mesh: the SPA on phase 8's final problem, node poses perturbed by {MESH_SPA_PERTURB} (seed 0) "
          f"({n_sub} submaps, {n_node} nodes, {n_c} of {rows} constraint rows, valid rows by shard "
          f"{valid_per_shard}; {MESH_SPA_ITERATIONS} GN steps of 64 CG steps), ms a GN step (host clock, "
          f"streams synchronized): compiled {ms['compiled_sharded']:.2f} over {mesh.size} shards, "
          f"{ms['compiled_unsharded']:.2f} unsharded (first call, warm-ups and captures: "
          f"{first_ms['sharded']:.1f} / {first_ms['unsharded']:.1f} ms); eager {ms['eager_sharded']:.2f} "
          f"sharded, {ms['eager_unsharded']:.2f} unsharded; the solve moved a node by up to {moved:.3e} m; "
          f"tolerance {tol:.3e} (spa_tolerance: {MESH_SPA_RTOL} x moved + {MESH_SPA_ULPS} spacings of "
          f"{scale:.3f}); compiled vs eager ({1 + MESH_SPA_CALLS} calls each): sharded {held['sharded']:.3e}, "
          f"unsharded {held['unsharded']:.3e}; sharded vs unsharded: eager {diff['eager']:.3e}, compiled "
          f"{diff['compiled']:.3e}; each against a float64 solve: "
          + ", ".join(f"{k} {v:.3e} ({v / moved:.2e} of the movement)" for k, v in f64.items())
          + f"; program counts {counts}; at other noise (compiled solves against float64): "
          + "; ".join(f"{k}: moved {v['moved']:.3e}, sharded vs unsharded {v['sharded_vs_unsharded']:.3e}, "
                      + ", ".join(f"{n} {x:.3e} ({x / v['moved']:.2e})" for n, x in v["f64_error"].items())
                      for k, v in premise.items()), flush=True)
    for name in cases:
        check(held[name] <= tol, f"phase 16: compiled {name} SPA vs eager: {held[name]:.3e} > {tol:.3e}")
    for name, e in f64.items():
        check(e <= tol / 2, f"phase 16: the {name} SPA departs from a float64 solve by {e:.3e} > {tol / 2:.3e}, "
              "spa_tolerance's premise")
    for noise, v in premise.items():
        check(max(v["f64_error"].values()) <= v["tolerance"] / 2 and v["sharded_vs_unsharded"] <= v["tolerance"],
              f"phase 16: the SPA at noise {noise}: {v}")
    for kind, d in diff.items():
        check(d <= tol, f"phase 16: {kind} sharded SPA vs unsharded poses differ by {d:.3e} > {tol:.3e}")
    check(moved > MESH_SPA_MOVES, f"phase 16: the solve moved a node by {moved:.3e} m, not more than "
          f"{MESH_SPA_MOVES:.0e} m")
    check(all(valid_per_shard) or n_c < mesh.size, f"phase 16: every shard holds valid rows {valid_per_shard}")
    gn, cg_steps = (1 + MESH_SPA_CALLS) * MESH_SPA_ITERATIONS, _spa_settings(op, blocks)["cg_iterations"]
    for name, m in (("sharded", mesh.size), ("unsharded", 1)):
        want = {k: {"steps": gn * each * n, "warmups": n, "captures": n, "replays": gn * each * n - n}
                for k, each, n in (("spa_rows", 1, m), ("spa_jtj", cg_steps, m), ("spa_start", 1, 1),
                                   ("spa_cg", cg_steps, 1), ("spa", 1, 1))}
        check(counts[name] == want, f"phase 16: compiled {name} SPA program counts {counts[name]}, not {want}")
    return {"gn_step_ms": ms["eager_sharded"], "unsharded_gn_step_ms": ms["eager_unsharded"],
            "compiled_gn_step_ms": ms["compiled_sharded"], "compiled_unsharded_gn_step_ms": ms["compiled_unsharded"],
            "compiled_first_call_ms": first_ms, "held": held, "pose_diff": diff, "tolerance": tol,
            "moved_m": moved, "f64_error": f64, "constraints": n_c, "valid_rows_by_shard": valid_per_shard,
            "submaps": n_sub, "nodes": n_node, "program_counts": counts, "premise": premise}


def chunk_diff(a, b):
    """Two packed (B, 9) search results of one chunk, unsharded `a` and
    sharded `b`: their largest pose difference and its tolerance,
    MESH_POSE_ATOL per metre of the largest translation above 1 m."""
    return float((a[:, 2:] - b[:, 2:]).abs().max()), MESH_POSE_ATOL * max(1.0, float(a[:, 6:9].abs().max()))


def mesh_search(mesh, dev):
    """Phase 16 (c): phase 8's with-initial search chunk through a pose
    graph over the mesh against one without: found and score equal, poses
    within MESH_POSE_ATOL; the second call of each (a replay) timed."""
    from torch.utils._pytree import tree_map

    from dliom_tpu_torch.backend.pose_graph import PoseGraph
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.common.mesh import split_sizes

    hit, arrays = MESH_INPUTS["chunk"]
    hit = tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, hit)
    cfg = load_config("basic", E2E_OVERRIDES)
    out, ms = {}, {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        pg = PoseGraph(cfg.pose_graph, cfg.trajectory_builder, device=dev, mesh=m)
        pg._search("search_initial", hit, arrays)  # warm-up and capture
        sync_mesh(mesh)
        t0 = time.perf_counter()
        out[name] = pg._search("search_initial", hit, arrays).cpu()
        sync_mesh(mesh)
        ms[name] = (time.perf_counter() - t0) * 1e3
        del pg
    a, b = out["unsharded"], out["sharded"]
    pose, pose_tol = chunk_diff(a, b)
    found = int((a[:, 0] > 0.5).sum())
    print(f"mesh: phase 8's with-initial search chunk of {a.shape[0]} nodes over {mesh.size} shards (pieces of "
          f"{' / '.join(str(n) for n in split_sizes(a.shape[0], mesh))}): "
          f"{ms['sharded']:.2f} ms against {ms['unsharded']:.2f} ms unsharded (a replay each, host clock, "
          f"synchronized); {found} found; found and score equal: {torch.equal(a[:, :2], b[:, :2])}; "
          f"poses differ by {pose:.3e} (tolerance {pose_tol:.3e})", flush=True)
    check(torch.equal(a[:, :2], b[:, :2]), f"phase 16: the chunk's found and score differ: {a[:, :2]} {b[:, :2]}")
    check(pose <= pose_tol, f"phase 16: the chunk's poses differ by {pose:.3e}")
    return {"nodes": a.shape[0], "found": found, "ms": ms["sharded"], "unsharded_ms": ms["unsharded"],
            "pose_diff": pose, "pose_tolerance": pose_tol}


def mesh_builder(ga, ac, mesh, dev):
    """Phase 16 (d): `MapBuilder(mesh=)` with its pool threads on phase 8's
    course (cut so that submaps finish and solves fall early), every loop
    search chunk and SPA solve of its pool recorded, then each held against
    an unsharded pose graph on the same inputs; see the module docstring."""
    from dliom_tpu_torch.backend import optimization as opt
    from dliom_tpu_torch.backend.pose_graph import PoseGraph
    from dliom_tpu_torch.common.config import load_config
    from dliom_tpu_torch.common.mesh import indexed
    from dliom_tpu_torch.map_builder import MapBuilder

    cfg = load_config("basic", E2E_OVERRIDES).override({
        "trajectory_builder": {"submaps": {"num_range_data": MESH_BUILDER_RANGE_DATA}},
        "pose_graph": {"optimize_every_n_nodes": MESH_BUILDER_OPTIMIZE}})
    course = e2e_course(MESH_BUILDER_SCANS + MESH_BUILDER_MORE, radius=E2E_RADIUS)
    builder = MapBuilder(cfg, use_background_threads=True, pipeline_depth=1, device=dev, mesh=mesh)
    pg = builder.pose_graph
    main_thread = threading.get_ident()
    searches, solves = [], []  # appended on the pool threads
    search, solve = pg._search, pg._solve

    def recorded_search(kind, hit, arrays):
        out = search(kind, hit, arrays)  # a new tensor, its task's streams drained before the task ends
        searches.append((kind, hit, arrays, out, threading.get_ident()))
        return out

    def recorded_solve(problem, iterations, blocks):
        out = solve(problem, iterations, blocks)
        solves.append((problem, iterations, blocks, out, threading.get_ident()))
        return out

    pg._search, pg._solve = recorded_search, recorded_solve
    eager_gn = []  # threads that ran an eager SPA GN step
    eager_gn_step = opt._gn_step

    def counted_gn_step(*args, **kwargs):
        eager_gn.append(threading.get_ident())
        return eager_gn_step(*args, **kwargs)

    opt._gn_step = counted_gn_step
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.LAUNCHES = ga.DENSE_LAUNCHES = ac.LAUNCHES = wo.LAUNCHES = 0  # the builder's main path starts: zero the launch counts
    t0 = time.perf_counter()
    n = 0
    while n < MESH_BUILDER_SCANS or (not (searches and solves) and n < MESH_BUILDER_SCANS + MESH_BUILDER_MORE):
        more = MESH_BUILDER_SCANS if n == 0 else 8
        drive(builder, course[n:n + more])
        n += more
        builder.flush()
        pg.wait_for_all_computations()
    course_s = time.perf_counter() - t0
    launches = {"grouped_apply": ga.LAUNCHES, "grouped_apply_dense": ga.DENSE_LAUNCHES,
                "affine_chain": ac.LAUNCHES}
    K3_BY_PATH["mesh_builder"] = wo.LAUNCHES
    pg._search, pg._solve = search, solve
    opt._gn_step = eager_gn_step
    spa_counts = {k: v for k, v in pg.graph_counts().items() if k.startswith("spa")}
    results = builder.local_trajectory(0)
    stepped = len(results)
    counts = check_graph_counts("mesh builder", builder.step_counts(), stepped)
    check_trajectory("mesh builder", builder, results)
    check(launches == {"grouped_apply": 2 * stepped, "grouped_apply_dense": 2 * stepped, "affine_chain": stepped},
          f"mesh builder: launches {launches} for {stepped} stepped scans (K1 dense 2, also counted as K1's; "
          "K2 1 a scan)")
    check(K3_BY_PATH["mesh_builder"] == stepped,
          f"mesh_builder: K3 {K3_BY_PATH['mesh_builder']} launches for {stepped} steps")
    on_pool = (sum(t != main_thread for *_, t in searches), sum(t != main_thread for *_, t in solves))
    check(searches and solves and on_pool == (len(searches), len(solves)),
          f"mesh builder: {len(searches)} search chunks and {len(solves)} solves, {on_pool} of them on the "
          "pool threads")
    widest = max(len(arrays[0]) for _, _, arrays, _, _ in searches)
    program_devices = {d for _, d in pg._programs_by_thread}
    stream_devices = {d for _, d in pg._streams}
    check(stream_devices == set(mesh.distinct_devices) | {indexed(pg.device)},
          f"mesh builder: the pool tasks' streams on {sorted(map(str, stream_devices))}")
    check(widest < mesh.size or program_devices == set(mesh.distinct_devices),
          f"mesh builder: search programs on {sorted(map(str, program_devices))}, chunks up to {widest} nodes")
    check(not eager_gn, f"mesh builder: {len(eager_gn)} eager SPA GN steps ran, {sum(t != main_thread for t in eager_gn)} "
          "of them on the pool threads")
    check(set(spa_counts) == {"spa_rows", "spa_jtj", "spa_start", "spa_cg", "spa"}
          and all(c["replays"] >= 1 and c["warmups"] == c["captures"] and c["steps"] == c["warmups"] + c["replays"]
                  for c in spa_counts.values()), f"mesh builder: the SPA programs' counts {spa_counts}")

    ref = PoseGraph(cfg.pose_graph, cfg.trajectory_builder, device=dev)
    worst_pose, worst_spa, spa_tol, moved, found = 0.0, 0.0, 0.0, 0.0, 0
    for kind, hit, arrays, out, _ in searches:
        want = ref._search(kind, hit, arrays).cpu()
        got = out.cpu()
        pose, tol = chunk_diff(want, got)
        check(torch.equal(want[:, :2], got[:, :2]), f"mesh builder: a {kind} chunk's found and score differ: "
              f"{want[:, :2]} {got[:, :2]}")
        check(pose <= tol, f"mesh builder: a {kind} chunk's poses differ by {pose:.3e} (tolerance {tol:.3e})")
        worst_pose, found = max(worst_pose, pose), found + int((got[:, 0] > 0.5).sum())
    for problem, iterations, blocks, out, _ in solves:
        want = ref._solve(problem, iterations, blocks)
        before = np.concatenate([problem[f].reshape(-1) for f in ("submap_q", "submap_t", "node_q", "node_t",
                                                                   "lm_positions")])
        d = float(np.abs(out - want).max())
        tol = spa_tolerance(float(np.abs(want - before).max()),
                            max(float(np.abs(problem[f]).max()) for f in ("submap_t", "node_t")))
        check(d <= tol, f"mesh builder: a pool's sharded solve differs from unsharded by {d:.3e} > {tol:.3e}")
        worst_spa, spa_tol = max(worst_spa, d), max(spa_tol, tol)
        moved = max(moved, float(np.abs(want - before).max()))
    kinds = collections.Counter(k for k, *_ in searches)
    print(f"mesh: MapBuilder(mesh=) with {cfg.map_builder.num_background_threads} pool threads on phase 8's "
          f"course (num_range_data {MESH_BUILDER_RANGE_DATA}, optimize_every_n_nodes {MESH_BUILDER_OPTIMIZE}): "
          f"{n} scans ({stepped} stepped) in {course_s:.1f} s, nodes {len(pg.nodes)} submaps {len(pg.submaps)} "
          f"INTER {pg.num_inter_constraints()}; on the pool threads {len(searches)} search chunks "
          f"({dict(kinds)}, up to {widest} nodes, {found} found) and {len(solves)} sharded solves; search "
          f"programs on {sorted(map(str, program_devices))}, task streams on "
          f"{sorted(map(str, stream_devices))}; held against an unsharded pose graph on the same inputs: "
          f"found and score equal, poses within {worst_pose:.3e}; solves within {worst_spa:.3e} (tolerance "
          f"up to {spa_tol:.3e}, spa_tolerance; they moved a pose by up to {moved:.3e}); the SPA programs "
          f"(no eager GN step ran): {spa_counts}; launches {launches}", flush=True)
    del ref, builder, pg, searches, solves
    return launches, {"scans": n, "stepped": stepped, "seconds": course_s, "search_chunks": dict(kinds),
                      "solves": on_pool[1], "found": found, "chunk_pose_diff": worst_pose,
                      "spa_pose_diff": worst_spa, "spa_moved": moved, "spa_programs": spa_counts,
                      "compiled_step": counts,
                      "program_devices": sorted(map(str, program_devices)),
                      "stream_devices": sorted(map(str, stream_devices))}


def frontend_mesh_config():
    """(e): tests/test_torch_mesh.py's frontend config (tests/test_parallel.py
    :26-46), its dense grids on K1's dense entry: dense_apply_groups
    MESH_FRONTEND_GROUPS, and the low extent 48 -> 32, since K1's groups of
    16384 cells must divide the bank (2 x 48^3 cells do not)."""
    from dliom_tpu_torch.common.config import load_config

    return load_config("basic", {"trajectory_builder": {
        "min_range": 0.5, "max_range": 50.0, "voxel_filter_size": 0.2, "scan_period": 0.3,
        "ceres_scan_matcher": {"max_num_iterations": 6},
        "motion_filter": {"max_time_seconds": 0.0, "max_distance_meters": 0.0, "max_angle_radians": 0.0},
        "submaps": {"high_resolution": 0.25, "high_resolution_max_range": 50.0, "low_resolution": 0.8,
                    "num_range_data": 100, "high_resolution_extent": 96, "low_resolution_extent": 32,
                    "dense_apply_groups": MESH_FRONTEND_GROUPS},
        "max_filtered_points": 1024, "max_high_res_points": 512, "max_low_res_points": 512,
    }}).trajectory_builder


def frontend_scans(cfg, device, batch, steps):
    """tests/test_parallel.py's scan batch (lane b in its world offset 0.05 b
    m along x) at every step, the body 0.02 m further along x a step,
    stamped 0.3 s apart."""
    from dliom_tpu_torch.frontend.local_trajectory_builder import ScanInput
    from dliom_tpu_torch.io.synthetic import SyntheticWorld
    from dliom_tpu_torch.sensor.types import pad_point_cloud
    from dliom_tpu_torch.transform.rigid import Rigid3

    world = SyntheticWorld.create(num_beams=4, num_azimuths=100)
    out = []
    for k in range(steps):
        clouds = [pad_point_cloud(*world.cast_scan(Rigid3.translation_only(
            np.asarray([0.05 * b + 0.02 * k, 0.0, 0.0], np.float32))), cfg.max_filtered_points)
            for b in range(batch)]
        stack = lambda f: torch.from_numpy(np.stack([np.asarray(getattr(c, f)) for c in clouds])).to(device)  # noqa: E731
        out.append(ScanInput(
            time=torch.full((batch,), 0.3 * (k + 1), device=device), points=stack("points"), times=stack("times"),
            mask=torch.ones(batch, cfg.max_filtered_points, dtype=torch.bool, device=device),
            relative_prediction=Rigid3(torch.tensor([[1.0, 0.0, 0.0, 0.0]] * batch, device=device),
                                       torch.zeros(batch, 3, device=device))))
    return out


def mesh_frontend(ga, ac, mesh):
    """Phase 16 (e): the compiled frontend `sharded_step` (a StepGraph of the
    batched frontend step per shard), MESH_LANES lanes a shard, at
    `frontend_mesh_config`, MESH_FRONTEND_STEPS steps: every step of every
    shard (the first the warm-up and capture, then replays) held against
    the eager `batched_step` from copies of the same pre-step state
    (integer state and result flags bit for bit, float state and poses
    within HELD_ATOL); K1's dense entry 2 launches a shard a step, counted
    through the replays, no K2; no drops."""
    from torch.utils._pytree import tree_leaves

    from dliom_tpu_torch.common.mesh import shard_over_mesh
    from dliom_tpu_torch.parallel.batch import batched_step, make_batched_state, sharded_step

    d = mesh.size
    batch = MESH_LANES * d
    cfg = frontend_mesh_config()
    scans = [shard_over_mesh(x, mesh) for x in frontend_scans(cfg, mesh.first, batch, MESH_FRONTEND_STEPS)]
    states = [make_batched_state(cfg, MESH_LANES, dev) for dev in mesh.devices]  # lanes from 0 on each shard
    step, body = sharded_step(cfg, mesh), batched_step(cfg)
    ints, floats, pose = [], 0.0, 0.0
    from dliom_tpu_torch.imu import window_optimizer as wo

    ga.LAUNCHES = ga.DENSE_LAUNCHES = ac.LAUNCHES = wo.LAUNCHES = 0  # the sharded frontend step starts: zero the launch counts
    t0 = time.perf_counter()
    for k, inputs in enumerate(scans):
        pre = [tree_clone(st) for st in states]
        states, res = step(states, inputs)
        sync_mesh(mesh)
        for s_, dev in enumerate(mesh.devices):
            with torch.cuda.device(dev):
                want = without_launches(lambda: body(pre[s_], inputs[s_]))
            for x, y in zip(tree_leaves((states[s_], res[s_])), tree_leaves(want)):
                if x is None:
                    continue
                if x.dtype.is_floating_point:
                    floats = max(floats, float((x - y).abs().max()) if x.numel() else 0.0)
                elif not torch.equal(x, y):
                    ints.append((k, s_))
            pose = max(pose, float((res[s_].local_pose.translation - want[1].local_pose.translation).abs().max()),
                       float((res[s_].local_pose.rotation - want[1].local_pose.rotation).abs().max()))
    seconds = time.perf_counter() - t0
    launches = {"grouped_apply": ga.LAUNCHES, "grouped_apply_dense": ga.DENSE_LAUNCHES,
                "affine_chain": ac.LAUNCHES}
    K3_BY_PATH["mesh_frontend"] = wo.LAUNCHES
    n = d * MESH_FRONTEND_STEPS
    counts = step.counts()
    drops = sum(int(st.submaps.dense_dropped.sum()) for st in states)
    print(f"mesh: the frontend's compiled sharded_step, B={batch} over {d} shards ({MESH_LANES} lanes each), "
          f"{MESH_FRONTEND_STEPS} steps (tests/test_torch_mesh.py's frontend config, dense_apply_groups "
          f"{MESH_FRONTEND_GROUPS}, low extent 32) in {seconds:.2f} s with the holds: every shard's step against "
          f"the eager batched_step from the same pre-step state: integer state and flags differ at {ints or 'none'}, "
          f"float state within {floats:.3e}, poses within {pose:.3e}; counts {counts}; drops {drops}; launches "
          f"{launches}", flush=True)
    check(not ints, f"phase 16 (e): integer state differs at (step, shard) {ints}")
    check(pose <= HELD_ATOL and floats <= HELD_ATOL, f"phase 16 (e): poses {pose:.3e}, float state {floats:.3e}")
    check(counts == {"steps": n, "warmups": d, "captures": d, "replays": n - d}, f"phase 16 (e): counts {counts}")
    check(launches == {"grouped_apply": 2 * n, "grouped_apply_dense": 2 * n, "affine_chain": 0},
          f"phase 16 (e): launches {launches} for {MESH_FRONTEND_STEPS} steps over {d} shards (K1 dense 2 a shard a step)")
    check(K3_BY_PATH["mesh_frontend"] == 0,
          f"mesh_frontend: K3 {K3_BY_PATH['mesh_frontend']} launches: the frontend step has no window")
    check(drops == 0, f"phase 16 (e): dropped grid updates {drops}")
    return launches, {"lanes": batch, "shards": d, "steps": MESH_FRONTEND_STEPS, "seconds": seconds,
                      "pose_diff": pose, "float_diff": floats, "compiled_step": counts}


def check_mesh(ga, ac, dev):
    """Phase 16: the mesh scale-out; see the module docstring."""
    t0 = time.perf_counter()
    mesh = phase_mesh()
    distinct = len(mesh.distinct_devices)
    print(f"mesh: {mesh}; distinct_devices {distinct} of {torch.cuda.device_count()} cards"
          + ("" if distinct > 1 else " (every shard on one card: the cross-card path is not run)"), flush=True)
    launches, lio = mesh_lio(ga, ac, mesh)
    t1 = time.perf_counter()
    spa = mesh_spa(mesh)
    t2 = time.perf_counter()
    search = mesh_search(mesh, dev)
    t3 = time.perf_counter()
    builder_launches, builder = mesh_builder(ga, ac, mesh, dev)
    t4 = time.perf_counter()
    frontend_launches, frontend = mesh_frontend(ga, ac, mesh)
    seconds = time.perf_counter() - t0
    print(f"phase 16: {seconds:.1f} s (aim {PHASE16_AIM_S:.0f} s; (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
          f"(c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}, (e) {seconds - t4 + t0:.1f})", flush=True)
    return {**launches, "builder": builder_launches, "frontend": frontend_launches}, {
        "mesh": [str(d) for d in mesh.devices], "distinct_devices": distinct, "lio": lio, "spa": spa,
        "search": search, "builder": builder, "frontend": frontend, "seconds": seconds}


def main():
    start = time.perf_counter()
    card = environment()
    import dliom_tpu_torch  # noqa: F401  (pins f32, TF32 off)
    from dliom_tpu_torch import kernels
    from dliom_tpu_torch.common.device import get_device
    from dliom_tpu_torch.imu import affine_chain as ac
    from dliom_tpu_torch.ops import grouped_apply as ga

    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    t3 = time.perf_counter()
    k1, launch_floor = check_grouped_apply(ga, rng)
    t4 = time.perf_counter()
    k2 = check_affine_chain(ac, rng)
    t4b = time.perf_counter()
    k3 = check_window_gn(get_device("cuda"))
    t5 = time.perf_counter()
    print(f"phase 3: {t4 - t3:.1f} s; phase 4: {t4b - t4:.1f} s; phase 4b: {t5 - t4b:.1f} s")
    launches, scans_per_s, spawn = check_slice(ga, ac, get_device("cuda"))
    t14 = time.perf_counter()
    print(f"phases 5-6: {t14 - t5:.1f} s")
    compiled_launches, compiled = check_compiled(ga, ac, get_device("cuda"), scans_per_s, launches, spawn)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s")
    t7 = time.perf_counter()
    k1d, dense_kernels = check_dense_grouped_apply(ga, rng)
    print(f"phase 7: {time.perf_counter() - t7:.1f} s")
    check(dense_kernels == 1, f"K1 dense entry: {dense_kernels} device kernels per call, not 1")
    t8 = time.perf_counter()
    gc.collect()
    mem = torch.cuda.memory_allocated()
    map_launches, mapping = check_mapping(ga, ac, get_device("cuda"))
    gc.collect()
    mapping["left_by_builder_mib"] = (torch.cuda.memory_allocated() - mem) / 2**20
    print(f"mapping: device memory allocated after the builder was freed, beside before it was made: "
          f"{mapping['left_by_builder_mib']:+.1f} MiB")
    print(f"phase 8: {time.perf_counter() - t8:.1f} s")
    t9 = time.perf_counter()
    campus_k2, campus = check_campus(ac, get_device("cuda"))
    viral_k2, viral = check_viral(ac, get_device("cuda"))
    rtc_k2, correlative = check_correlative(ac, get_device("cuda"))
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:  # phase 10's checkpoint, builder B and its scans last to phase 12
        t10 = time.perf_counter()
        io_launches, runner_k2, io, resumed = check_io(ga, ac, get_device("cuda"), tmp)
        phase10_s = time.perf_counter() - t10
        print(f"phase 10: {phase10_s:.1f} s (aim {PHASE10_AIM_S:.0f} s)")
        batched_launches, batched = check_batched(ga, ac, get_device("cuda"), scans_per_s)
        cloud_launches, cloud = check_cloud(ga, ac, get_device("cuda"), resumed, tmp)
        del resumed
        long_course_k2, loop_tools = check_loop_tools(ga, ac, get_device("cuda"), tmp)
    gc.collect()
    bench_launches, bench = check_bench(ga, ac, get_device("cuda"))
    gc.collect()
    mesh_launches, mesh = check_mesh(ga, ac, get_device("cuda"))
    check("jax" not in sys.modules and "msgpack" not in sys.modules, "no jax or msgpack imported")
    k2_launches = {"slice": launches["affine_chain"], "compiled": compiled_launches["affine_chain"],
                   "mapping": map_launches["affine_chain"],
                   "campus": campus_k2, "viral": viral_k2, "correlative": rtc_k2,
                   "checkpoint": io_launches["affine_chain"], "runner": runner_k2,
                   "batched": batched_launches["affine_chain"], "cloud": cloud_launches["affine_chain"],
                   "long_course": long_course_k2,
                   "bench_frontend": bench_launches["bench_frontend"]["affine_chain"],
                   "flagship": bench_launches["flagship"]["affine_chain"],
                   "mesh": mesh_launches["affine_chain"],
                   "mesh_builder": mesh_launches["builder"]["affine_chain"]}
    k1_launches = {"slice": launches["grouped_apply"], "compiled": compiled_launches["grouped_apply"],
                   "batched": batched_launches["grouped_apply"],
                   "bench_frontend": bench_launches["bench_frontend"]["grouped_apply"],
                   "flagship": bench_launches["flagship"]["grouped_apply"],
                   "mesh": mesh_launches["grouped_apply"]}
    dense_launches = {"mapping": map_launches["grouped_apply_dense"],
                      "checkpoint": io_launches["grouped_apply_dense"],
                      "batched": batched_launches["grouped_apply_dense"],
                      "cloud": cloud_launches["grouped_apply_dense"],
                      "mesh_builder": mesh_launches["builder"]["grouped_apply_dense"],
                      "mesh_frontend": mesh_launches["frontend"]["grouped_apply_dense"]}

    print(json.dumps({"card": card, "slice_scans_per_s": scans_per_s, "compiled": compiled, "mapping": mapping,
                      "campus": campus, "viral": viral, "correlative": correlative, "io": io,
                      "phase10_seconds": phase10_s, "batched": batched, "cloud": cloud, "loop_tools": loop_tools,
                      "bench": bench, "mesh": mesh,
                      "dense_kernels_per_call": dense_kernels, "empty_launch_graph_ms": launch_floor,
                      "grouped_apply_by_shape": {**k1, **k1d},
                      "affine_chain_by_length": k2, "affine_chain_launches": k2_launches,
                      "window_gn_by_shape": k3,
                      "reduced": {"mapping": f"the course's circle 5 m -> {E2E_RADIUS} m, its warm-up "
                                             f"235 scans -> {mapping['warm_up_scans']}; timed scans "
                                             f"209 -> {mapping['timed_scans']}",
                                  "viral": f"submaps.num_range_data 100 -> {VIRAL_RANGE_DATA}: "
                                           "a slot recycle needs 2 x num_range_data inserts, "
                                           f"which the course's {E2E_STATIC + VIRAL_MOVING} scans make",
                                  "checkpoint": f"submaps.num_range_data 16 -> {CKPT_RANGE_DATA}: the first "
                                                "submap finishes after 2 x num_range_data inserts",
                                  "cloud": f"submaps.num_range_data 16 -> {CKPT_RANGE_DATA}: phase 10's "
                                           "checkpoint, which builder C restores",
                                  "batched_lanes": f"submaps.num_range_data 100 -> {LANES_RANGE_DATA}: "
                                                   "spawns and a slot recycle within "
                                                   f"{LANES_STEPS} steps",
                                  "batched_dense": f"submaps.num_range_data 16 -> {DENSE_LANES_RANGE_DATA}: "
                                                   f"a spawn within {DENSE_LANES_STEPS} steps",
                                  "campus": f"stepped scans after the initialization cut to {CAMPUS_STEPS}",
                                  "long_course": f"laps 2.0 -> {LONG_COURSE_LAPS}: the full course is ~2670 "
                                                 "scans, ~45-70 min at the runner's rate",
                                  "flagship": f"bench_e2e(flagship=True)'s course: the circle 5 m -> "
                                              f"{E2E_RADIUS} m, its warm-up 235 scans -> "
                                              f"{bench['flagship']['warm_up_scans']}; timed scans 209 -> "
                                              f"{bench['flagship']['timed_scans']}",
                                  "mesh_builder": f"phase 8's course cut to {mesh['builder']['scans']} scans; "
                                                  f"submaps.num_range_data 16 -> {MESH_BUILDER_RANGE_DATA}, "
                                                  "pose_graph.optimize_every_n_nodes 32 -> "
                                                  f"{MESH_BUILDER_OPTIMIZE}; no final optimization",
                                  "mesh_frontend": f"tests/test_torch_mesh.py's frontend config for "
                                                   f"{MESH_FRONTEND_STEPS} steps, its low extent 48 -> 32 and "
                                                   f"dense_apply_groups 0 -> {MESH_FRONTEND_GROUPS}, so that its "
                                                   "insert runs K1's dense entry"}}))

    def record(name, source, replaces, n, timed, err, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": n,
                "max_abs_err": err, **{k: timed[k] for k in ("ms", "event_ms", "graph_ms", "plain_ms",
                                                              "bound_ms", "bound_by")},
                "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        record("grouped_apply", "dliom_tpu_torch/csrc/grouped_apply.cu",
               "dliom_tpu/ops/pallas_apply.py:257", sum(k1_launches.values()), k1["high_spawn"],
               max(v["max_abs_err"] for v in k1.values()), launches_by_path=k1_launches),
        record("affine_chain", "dliom_tpu_torch/csrc/affine_chain.cu",
               "dliom_tpu/imu/preintegration.py:102", sum(k2_launches.values()), k2[IMU_CAP],
               max(v["max_abs_err"] for v in k2.values()), launches_by_path=k2_launches),
        record("window_gn", "dliom_tpu_torch/csrc/window_gn.cu", None, sum(K3_BY_PATH.values()),
               {"ms": None, "event_ms": None, "graph_ms": k3["W4_B1"]["k3_graph_ms"],
                "plain_ms": k3["W4_B1"]["plain_graph_ms"], "bound_ms": k3["W4_B1"]["chain_bound_ms"],
                "bound_by": "chain"},
               max(g["gap"] for k, m in k3.items() if k != "chain_latency_ns"
                   for gaps in m["gaps"].values() for g in gaps.values()),
               launches_by_path=dict(K3_BY_PATH),
               by_shape={k: {x: m[x] for x in ("k3_graph_ms", "plain_graph_ms", "chain_bound_ms")}
                         for k, m in k3.items() if k != "chain_latency_ns"}),
        record("grouped_apply_dense", "dliom_tpu_torch/csrc/grouped_apply.cu",
               "dliom_tpu/ops/pallas_apply.py:215", sum(dense_launches.values()), k1d["dense"],
               max(v["max_abs_err"] for v in k1d.values()), launches_by_path=dense_launches,
               device_split_ms=k1d["dense"]["device_split_ms"]),
    ]}))
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Typed configuration tree for the engine.

A verbatim copy of `dliom_tpu/common/config.py`: importing that module runs
`dliom_tpu/__init__.py`, which imports jax, and this package never does.
tests/test_torch_config.py holds the two trees equal.

Counterpart of the reference's Lua config system
(`cartographer/common/lua_parameter_dictionary.{h,cc}` + the option structs
produced by each module's `Create*Options`): a tree of frozen dataclasses with

  * defaults equal to the reference's shipped configuration
    (`configuration_files/trajectory_builder_3d.lua`, `pose_graph.lua`,
    `map_builder.lua`) overlaid with D-LIOM's `basic_config_3d.lua`,
  * dict-based overrides with *strict unknown-key detection* (the parity
    feature of LuaParameterDictionary's reference counting),
  * named presets mirroring `src/dlio/config/*.lua` (viral, kaist, kitti, ...)
    implemented as override dicts with an include chain.

Capacity fields (`max_*`) have no reference analog: they pin the static shapes
every XLA computation is compiled with.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Tuple


def _replace_strict(obj, overrides: Mapping[str, Any], path: str = ""):
    """Apply nested dict overrides to a dataclass tree; raise on unknown keys."""
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"{path or '<root>'} is not a config node")
    names = {f.name for f in dataclasses.fields(obj)}
    updates = {}
    for key, value in overrides.items():
        if key not in names:
            raise KeyError(f"unknown config key '{path}{key}'")
        current = getattr(obj, key)
        if isinstance(value, Mapping) and dataclasses.is_dataclass(current):
            updates[key] = _replace_strict(current, value, f"{path}{key}.")
        else:
            updates[key] = value
    return dataclasses.replace(obj, **updates)


@dataclass(frozen=True)
class AdaptiveVoxelFilterConfig:
    # trajectory_builder_3d.lua high/low_resolution_adaptive_voxel_filter
    max_length: float = 2.0
    min_num_points: int = 150
    max_range: float = 15.0


@dataclass(frozen=True)
class RangeDataInserterConfig:
    # trajectory_builder_3d.lua submaps.range_data_inserter
    hit_probability: float = 0.55
    miss_probability: float = 0.49
    num_free_space_voxels: int = 2


@dataclass(frozen=True)
class SubmapsConfig:
    # trajectory_builder_3d.lua submaps, overlaid with basic_config_3d.lua
    high_resolution: float = 0.2
    high_resolution_max_range: float = 60.0
    low_resolution: float = 0.45
    num_range_data: int = 100
    range_data_inserter: RangeDataInserterConfig = field(
        default_factory=RangeDataInserterConfig
    )
    # --- TPU capacity knobs (no reference analog) ---
    # Grid extent in cells per axis (must be even); the grid spans
    # [-extent/2, extent/2) * resolution around the submap origin.
    high_resolution_extent: int = 512
    low_resolution_extent: int = 256
    # Brick (two-level) high-res grid: covers ±brick_dir_extent*4*resolution
    # like the reference's HybridGrid pointer tree (hybrid_grid.h), so
    # high_resolution_max_range is honored at fine resolutions where a dense
    # grid cannot span it. high_resolution_extent then only sizes the
    # backend's dense capture crop.
    use_brick_grid: bool = False
    brick_dir_extent: int = 160  # bricks/axis; 160*8*0.1m = ±64 m at 0.1 m
    brick_max_bricks: int = 65536
    # > 0 routes brick insertion through the grouped Pallas apply kernel
    # (per-insert touched-group capacity); 0 = XLA sort/scatter path.
    brick_apply_groups: int = 0
    brick_apply_group_bricks: int = 32  # bricks per kernel group (pow2)
    # > 0 routes DENSE grid insertion (low-res, and high-res when not using
    # the brick grid) through the grouped Pallas apply kernel; banks then
    # carry one 16384-cell padding group. 0 = XLA sort/scatter path.
    dense_apply_groups: int = 0
    # Brick (two-level) LOW-res grid: full max-range coverage for the
    # low-resolution matching grid too (the reference's low HybridGrid is
    # sparse and unbounded); low_resolution_extent then only sizes the
    # backend capture crop. Coarse cells make small pools sufficient.
    use_brick_grid_low: bool = False
    low_brick_dir_extent: int = 40  # 40*8*0.45 m = ±72 m at 0.45 m
    low_brick_max_bricks: int = 8192
    low_brick_apply_groups: int = 0
    low_brick_apply_group_bricks: int = 8


@dataclass(frozen=True)
class RealTimeCorrelativeConfig:
    # trajectory_builder_3d.lua real_time_correlative_scan_matcher (:45-50)
    linear_search_window: float = 0.15
    angular_search_window: float = 0.017453292519943295  # math.rad(1)
    translation_delta_cost_weight: float = 1e-1
    rotation_delta_cost_weight: float = 1e-1
    # TPU deviation knob: cap on rotational lattice steps per axis. The
    # reference enumerates the full acos-derived window (:64-72), which is
    # combinatorial at long max ranges; requesting a window wider than this
    # cap allows logs a truncation warning (ops/real_time_correlative.py).
    max_angular_steps: int = 4


@dataclass(frozen=True)
class CeresScanMatcherConfig:
    # trajectory_builder_3d.lua ceres_scan_matcher + basic_config_3d.lua
    occupied_space_weight_0: float = 1.0
    occupied_space_weight_1: float = 6.0
    translation_weight: float = 6.0
    rotation_weight: float = 45.0
    only_optimize_yaw: bool = False
    max_num_iterations: int = 12
    # Ceres terminates on |cost change| <= function_tolerance * cost; the
    # default matches the reference's effective Ceres default 1e-6
    # (CreateCeresSolverOptions leaves function_tolerance unset). A looser
    # 1e-3 is a measured throughput opt-in (the bench config uses it): on
    # the bench world it leaves the trajectory unchanged (+5.6 mm on a
    # 693 mm max-error course) while cutting steady-state iterations
    # 6 -> ~3-4 — but that calibration is world-specific, so the DEFAULT
    # stays at reference fidelity. 1e-2 visibly degrades (215 mm pose
    # divergence). 0 disables (fixed trip count).
    function_tolerance: float = 1e-6


@dataclass(frozen=True)
class MotionFilterConfig:
    # basic_config_3d.lua motion_filter
    max_time_seconds: float = 0.5
    max_distance_meters: float = 0.2
    max_angle_radians: float = math.radians(5.0)


@dataclass(frozen=True)
class ImuConfig:
    # trajectory_builder_3d.lua imu (D-LIOM addition, proto/imu_options.proto)
    acc_noise: float = 3.9939570888238808e-01
    gyr_noise: float = 1.5636343949698187e-03
    acc_bias_noise: float = 6.4356659353532566e-05
    gyr_bias_noise: float = 3.5640318696367613e-05
    gravity: float = 9.80511
    prior_pose_noise: float = 1e-2
    prior_vel_noise: float = 1e4
    prior_bias_noise: float = 1e-2
    ceres_pose_noise_t: float = 5e-2
    ceres_pose_noise_r: float = 5e-2
    ceres_pose_noise_t_drift: float = 3e-1
    ceres_pose_noise_r_drift: float = 1e-1
    prior_gravity_noise: float = 1e-2


@dataclass(frozen=True)
class TrajectoryBuilderConfig:
    """Local SLAM (frontend) options — TRAJECTORY_BUILDER_3D overlaid with
    basic_config_3d.lua."""

    min_range: float = 0.5
    max_range: float = 100.0
    num_accumulated_range_data: int = 1
    voxel_filter_size: float = 0.3
    scan_period: float = 0.1
    manual_deskew_stamps: bool = False  # eable_mannually_discrew
    enable_ndt_initialization: bool = False
    frames_for_static_initialization: int = 7
    frames_for_dynamic_initialization: int = 7
    frames_for_online_gravity_estimate: int = 7
    enable_gravity_factor: bool = True
    high_resolution_adaptive_voxel_filter: AdaptiveVoxelFilterConfig = field(
        default_factory=lambda: AdaptiveVoxelFilterConfig(2.0, 150, 15.0)
    )
    low_resolution_adaptive_voxel_filter: AdaptiveVoxelFilterConfig = field(
        default_factory=lambda: AdaptiveVoxelFilterConfig(4.0, 200, 60.0)
    )
    ceres_scan_matcher: CeresScanMatcherConfig = field(
        default_factory=CeresScanMatcherConfig
    )
    # trajectory_builder_3d.lua:44-50 (off by default, as in all dlio configs)
    use_online_correlative_scan_matching: bool = False
    real_time_correlative_scan_matcher: RealTimeCorrelativeConfig = field(
        default_factory=RealTimeCorrelativeConfig
    )
    # NOTE (dead-key policy): imu_gravity_time_constant is not carried — it
    # parameterizes the upstream ImuTracker/PoseExtrapolator, which is
    # vestigial in the D-LIOM 3D path (SURVEY C33: declared, never
    # constructed); prediction comes from IMU preintegration instead.
    motion_filter: MotionFilterConfig = field(default_factory=MotionFilterConfig)
    rotational_histogram_size: int = 120
    submaps: SubmapsConfig = field(default_factory=SubmapsConfig)
    imu: ImuConfig = field(default_factory=ImuConfig)
    # --- TPU capacity knobs ---
    max_raw_points: int = 131072  # raw points per accumulated scan
    max_filtered_points: int = 8192  # after fixed voxel filter
    # Matching-cloud capacities: the adaptive filters *target*
    # min_num_points (150/200), so matched clouds are typically a few
    # hundred points; these caps bound the compiled shapes.
    max_high_res_points: int = 1024  # after high-res adaptive filter
    max_low_res_points: int = 1024  # after low-res adaptive filter
    max_imu_per_scan: int = 64  # IMU samples bridging two scans
    window_size: int = 4  # sliding-window keys kept fully dense
    gn_iterations: int = 8  # window-optimizer Gauss-Newton iterations


@dataclass(frozen=True)
class FastCorrelativeConfig:
    # pose_graph.lua fast_correlative_scan_matcher_3d + basic_config_3d.lua
    branch_and_bound_depth: int = 8
    full_resolution_depth: int = 3
    min_rotational_score: float = 0.6
    min_low_resolution_score: float = 0.55
    linear_xy_search_window: float = 15.0
    linear_z_search_window: float = 8.0
    angular_search_window: float = math.radians(45.0)
    # TPU capacity knob: yaw candidates of the all-yaw MatchFullSubmap
    # search (the reference derives a step from the scan extent; a static
    # count keeps the compiled lattice shape fixed).
    full_submap_num_angles: int = 32


@dataclass(frozen=True)
class LoopCeresConfig:
    # pose_graph.lua constraint_builder.ceres_scan_matcher_3d
    occupied_space_weight_0: float = 5.0
    occupied_space_weight_1: float = 30.0
    translation_weight: float = 10.0
    rotation_weight: float = 10.0
    only_optimize_yaw: bool = False
    max_num_iterations: int = 10
    # Ceres-default convergence exit (see CeresScanMatcherConfig).
    function_tolerance: float = 1e-6


@dataclass(frozen=True)
class ConstraintBuilderConfig:
    # pose_graph.lua constraint_builder + basic_config_3d.lua overrides
    # NOTE (dead-key policy): keys that are defined but UNREAD in the
    # reference itself are not carried here — `sampling_ratio` (the upstream
    # node-vs-submap sampler path is commented out in D-LIOM,
    # pose_graph_3d.cc:368-381; every_nodes_to_find_constraint is the active
    # sampler) and the OpenCV SURF-path knobs (cv_binary_threshold,
    # cv_structure_element_size, minimum_good_match_num,
    # good_match_ratio_of_distance, ransac_thresh_of_2d_transform_estimate,
    # scale_estimated_tolerance — replaced by the image_proposal_* knobs of
    # the FFT-NCC substitute below). tests/test_config.py enforces that
    # every remaining key is read by some code path.
    max_constraint_distance: float = 50.0
    min_score: float = 0.45
    global_localization_min_score: float = 0.45
    loop_closure_translation_weight: float = 1e4
    loop_closure_rotation_weight: float = 1e2
    log_matches: bool = True
    # Robustness deviation (documented): the reference's with-initial fast
    # path searches EXACTLY the initial yaw
    # (MatchWith3DofInitial, fast_correlative_scan_matcher_3d.cc:165-196), so
    # a genuine loop whose initial guess carries accumulated yaw drift (the
    # very drift loop closure exists to fix) scores a smeared side peak and
    # can fall under min_score. A small yaw fan around the initial — a
    # restriction of upstream Match()'s full ±45° yaw search (:146-163) that
    # the with-initial fast path dropped — restores recovery; the
    # breadth-first batched BnB evaluates the fan at cost linear in the
    # count. 1 = exact MatchWith3DofInitial semantics.
    with_initial_num_yaw_candidates: int = 7
    with_initial_yaw_window: float = 0.15  # rad, fan half-width
    every_nodes_to_find_constraint: int = 3
    # --- TPU search-cost knobs (device-queue hygiene on a single chip:
    # loop-search programs share the chip with the latency-critical
    # frontend step, so their size must stay bounded) ---
    # Score pyramid depths above 1 with every N-th point only (documented
    # deviation, see fast_correlative.match_candidates; 1 = reference
    # ScoreCandidates semantics, full cloud at every depth).
    coarse_scoring_stride: int = 2
    # Cap the nodes per batched search dispatch; a finishing submap's
    # sampled nodes split into chunks of this size so no single device
    # program exceeds ~100 ms and ingest interleaves between chunks.
    max_nodes_per_search_dispatch: int = 4
    # --- TPU image-proposal substitute for the SURF path (C10): dense FFT
    # correlation over candidate yaws; min normalized-correlation score plays
    # the role of minimum_good_match_num/RANSAC gates ---
    use_image_proposals: bool = True
    image_proposal_min_score: float = 0.35
    image_proposal_num_yaw: int = 24
    image_proposal_size: int = 128
    max_image_proposal_candidates: int = 8
    fast_correlative_scan_matcher: FastCorrelativeConfig = field(
        default_factory=FastCorrelativeConfig
    )
    ceres_scan_matcher: LoopCeresConfig = field(default_factory=LoopCeresConfig)


@dataclass(frozen=True)
class OptimizationProblemConfig:
    # pose_graph.lua optimization_problem + basic_config_3d.lua.
    # NOTE (dead-key policy): acceleration_weight / rotation_weight (the IMU
    # cost blocks) are not carried — their code is commented out in the
    # reference (optimization_problem_3d.cc:350-489). The odometry and
    # local-slam consecutive-node costs from the same commented block ARE
    # restored here behind `use_consecutive_node_costs`.
    huber_scale: float = 1e2  # Huber loss on fixed-frame costs (:491-548)
    # Huber on INTER (loop) constraints too — upstream cartographer's
    # behavior; the D-LIOM reference replaced it with TrivialLoss (the
    # original shows in its comment, optimization_problem_3d.cc:335).
    # Default False = reference parity; True bounds the damage of a
    # false loop closure that slips past min_score.
    use_inter_huber: bool = False
    local_slam_pose_translation_weight: float = 1e5
    local_slam_pose_rotation_weight: float = 1e5
    odometry_translation_weight: float = 1e5
    odometry_rotation_weight: float = 1e5
    use_consecutive_node_costs: bool = False
    # fixed-frame observations are position-only (GPS/navsat carries no
    # orientation through the bridge), so only the translation weight
    # exists; the reference's rotation weight applies to oriented
    # fixed-frame poses it never receives from navsat either.
    fixed_frame_pose_translation_weight: float = 1e1
    log_solver_summary: bool = False
    max_num_iterations: int = 10


@dataclass(frozen=True)
class PoseGraphConfig:
    # POSE_GRAPH overlaid with basic_config_3d.lua
    optimize_every_n_nodes: int = 100
    constraint_builder: ConstraintBuilderConfig = field(
        default_factory=ConstraintBuilderConfig
    )
    matcher_translation_weight: float = 5e2
    matcher_rotation_weight: float = 1.6e3
    optimization_problem: OptimizationProblemConfig = field(
        default_factory=OptimizationProblemConfig
    )
    max_num_final_iterations: int = 400
    global_sampling_ratio: float = 0.1
    log_residual_histograms: bool = False
    global_constraint_search_after_n_seconds: float = 10.0
    # D-LIOM additions (pose_graph_options.proto:59-64).
    # NOTE (dead-key policy): nodes_space_to_perform_loop_detection is not
    # carried — its only reference use sits in a commented-out block
    # (pose_graph_3d.cc:368-381, the node-vs-submap search path).
    max_radius_enable_loop_detection: float = 10.0
    num_close_submaps_loop_with_initial_value: int = 5
    # --- TPU capacity knobs ---
    max_submaps: int = 512
    max_nodes: int = 8192
    max_constraints: int = 16384
    # Decompressed-grid + precomputation-pyramid LRU capacity (submaps held
    # on device for constraint search — the reference keeps every finished
    # submap's HybridGrid + PrecomputationGridStack3D alive; HBM bounds ours
    # to the hot set. Must exceed the per-search candidate fan-out
    # (num_close_submaps + image/global candidates), else every search
    # round re-decompresses every pair (~300 ms each). A flagship 448^3
    # target is ~400 MB decompressed → 12 ≈ 5 GB peak, within one v5e's
    # 16 GB HBM next to the frontend grids.
    grid_cache_size: int = 12


@dataclass(frozen=True)
class MapBuilderConfig:
    # map_builder.lua.
    # NOTE (dead-key policy): collate_by_trajectory is not carried — it
    # selects TrajectoryCollator vs Collator in the reference's single
    # shared-queue design; ingestion here is per-trajectory by construction
    # (each trajectory builder owns its OrderedMultiQueue).
    use_trajectory_builder_3d: bool = True
    num_background_threads: int = 8


@dataclass(frozen=True)
class EngineConfig:
    """Root config ≙ the `options` table of basic_config_3d.lua."""

    map_builder: MapBuilderConfig = field(default_factory=MapBuilderConfig)
    trajectory_builder: TrajectoryBuilderConfig = field(
        default_factory=TrajectoryBuilderConfig
    )
    pose_graph: PoseGraphConfig = field(default_factory=PoseGraphConfig)
    map_frame: str = "map"
    tracking_frame: str = "base_link"
    num_point_clouds: int = 1

    def override(self, overrides: Mapping[str, Any]) -> "EngineConfig":
        return _replace_strict(self, overrides)


# --- Presets: each mirrors a src/dlio/config/*.lua file as an override of
# the basic config (the include chain collapses into a single dict). ---

_VIRAL = {
    # src/dlio/config/viral.lua
    "tracking_frame": "imu",
    "num_point_clouds": 2,
    "pose_graph": {
        "optimize_every_n_nodes": 100,
        "max_radius_enable_loop_detection": 5.0,
        "num_close_submaps_loop_with_initial_value": 30,
    },
    "trajectory_builder": {
        "min_range": 1.0,
        "scan_period": 0.1,
        "enable_gravity_factor": False,
        # 0.1 m cells with high_resolution_max_range=60 need the brick grid
        # (a dense ±60 m grid at 0.1 m would be ~3.5 GB/slot)
        "submaps": {"high_resolution": 0.1, "use_brick_grid": True},
        "imu": {
            "acc_noise": 0.365432018302,
            "gyr_noise": 0.0367396706572,
            "acc_bias_noise": 0.000433,
            "gyr_bias_noise": 2.66e-05,
            "gravity": 9.80511,
            "prior_gravity_noise": 0.1,
            "ceres_pose_noise_t": 0.05,
            "ceres_pose_noise_r": 0.05,
            "ceres_pose_noise_t_drift": 0.01,
            "ceres_pose_noise_r_drift": 0.01,
            "prior_pose_noise": 0.05,
            "prior_vel_noise": 0.05,
            "prior_bias_noise": 1e-03,
        },
    },
}

_KAIST = {
    # src/dlio/config/kaist.lua spirit: urban driving, 2 VLP-16s, no gravity factor
    "tracking_frame": "imu",
    "num_point_clouds": 2,
    "pose_graph": {"optimize_every_n_nodes": 100},
    "trajectory_builder": {
        "min_range": 2.0,
        "max_range": 100.0,
        "enable_gravity_factor": False,
        "submaps": {"high_resolution": 0.2, "high_resolution_max_range": 80.0},
    },
}

_KITTI = {
    # src/dlio/config/kitti.lua spirit: single HDL-64, manual deskew stamps
    "tracking_frame": "imu",
    "num_point_clouds": 1,
    "trajectory_builder": {
        "min_range": 2.0,
        "max_range": 80.0,
        "manual_deskew_stamps": True,
        "enable_gravity_factor": False,
    },
}

_TONGJI = {
    "tracking_frame": "imu",
    "num_point_clouds": 1,
    "pose_graph": {"optimize_every_n_nodes": 100},
    "trajectory_builder": {"min_range": 1.0},
}

_CAMPUS = {
    # src/dlio/config/campus.lua: velodyne, gravity factor ON, huber 1e5
    "tracking_frame": "imu",
    "num_point_clouds": 1,
    "pose_graph": {
        "optimize_every_n_nodes": 100,
        "optimization_problem": {"huber_scale": 1e5},
    },
    "trajectory_builder": {
        "scan_period": 0.1,
        "manual_deskew_stamps": False,
        "frames_for_static_initialization": 5,
        "frames_for_dynamic_initialization": 7,
        "enable_ndt_initialization": True,
        "enable_gravity_factor": True,
        "submaps": {"high_resolution": 0.2, "num_range_data": 100},
        "imu": {
            "acc_noise": 3.9939570888238808e-01,
            "gyr_noise": 1.5636343949698187e-01,
            "acc_bias_noise": 6.4356659353532566e-05,
            "gyr_bias_noise": 3.5640318696367613e-05,
            "gravity": 9.80511,
            "prior_gravity_noise": 0.1,
            "ceres_pose_noise_t": 0.1,
            "ceres_pose_noise_r": 0.1,
            "ceres_pose_noise_t_drift": 0.01,
            "ceres_pose_noise_r_drift": 0.01,
            "prior_pose_noise": 1e-01,
            "prior_vel_noise": 1e-01,
            "prior_bias_noise": 1e-03,
        },
    },
}

_OUSTER = {
    # src/dlio/config/ouster.lua: OS1 (per-point t ns), synthetic stamps ON
    "tracking_frame": "imu",
    "num_point_clouds": 1,
    "trajectory_builder": {
        "scan_period": 0.1,
        "manual_deskew_stamps": True,
        "frames_for_static_initialization": 7,
        "frames_for_dynamic_initialization": 7,
        "enable_ndt_initialization": True,
        "imu": {
            "acc_noise": 1.249e2,
            "gyr_noise": 2.08e-1,
            "acc_bias_noise": 0.000106,
            "gyr_bias_noise": 0.000004,
            "gravity": 9.80511,
        },
    },
}

PRESETS: Dict[str, Mapping[str, Any]] = {
    "basic": {},
    "viral": _VIRAL,
    "kaist": _KAIST,
    "kitti": _KITTI,
    "tongji": _TONGJI,
    "campus": _CAMPUS,
    "ouster": _OUSTER,
}


def load_config(preset: str = "basic", overrides: Mapping[str, Any] | None = None) -> EngineConfig:
    if preset not in PRESETS:
        raise KeyError(f"unknown preset '{preset}'; have {sorted(PRESETS)}")
    cfg = EngineConfig().override(PRESETS[preset])
    if overrides:
        cfg = cfg.override(overrides)
    return cfg

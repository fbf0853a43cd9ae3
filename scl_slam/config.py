"""Typed configuration mirroring the reference's parameter surface.

The reference reads ~30 parameters from the ROS parameter server at
construction (``paramsServer``, reference ``include/distributedMapping.h:104-205``;
YAML defaults in ``config/dlc_fast_lio_velodyne.yaml:1-38``). Here the same
surface is a frozen dataclass tree, loadable from YAML/dict, validated at
construction (the reference calls ``ros::shutdown()`` on invalid values,
``distributedMapping.h:111,120,142``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Any


class LidarType(str, Enum):
    """reference ``include/distributedMapping.h:98,130-143``"""

    VELODYNE = "velodyne"
    LIVOX = "livox"


class DescriptorType(str, Enum):
    """reference ``include/distributedMapping.h:99,156-182``"""

    SCAN_CONTEXT = "scan_context"
    LIDAR_IRIS = "lidar_iris"
    M2DP = "m2dp"
    GRSD = "grsd"
    FPFH = "fpfh"
    SHOT = "shot"


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe gating + storage capacities."""

    # reference surroundingkeyframeAddingDistThreshold /
    # surroundingkeyframeAddingAngleThreshold (distributedMapping.h:195-196,772-779)
    distance_threshold: float = 1.0      # meters
    angle_threshold: float = 0.2         # radians
    max_keyframes: int = 4096            # device DB capacity (static shape)
    points_per_keyframe: int = 4096      # per-cloud capacity after downsample
    raw_points_capacity: int = 65536     # incoming scan capacity (descriptors
    #                                      are built from the raw scan; only
    #                                      storage is downsampled)
    descript_leaf_size: float = 0.2      # descriptor downsample (config yaml)
    map_leaf_size: float = 0.4           # global map publish leaf (:1646)
    # eviction (runtime/eviction.py): when a robot's block fills, keep the
    # newest evict_keep_recent frames + all loop anchors; temporally decimate
    # the rest, keeping every evict_stride-th. The reference grows unbounded.
    evict_keep_recent: int = 64
    evict_stride: int = 2
    # ingest storage downsample (descriptors always use the raw scan):
    #   "stride"     — fixed-permutation stride subsample, ONE gather
    #                  (~0.05 ms/frame at 64k->4096); no voxel dedup, so
    #                  near-field density persists (raw-scan statistics)
    #   "voxel_hash" — sort-free hash scatter voxel grid (~0.68 ms); rare
    #                  hash collisions merge voxels
    #   "voxel"      — exact sort-based voxel grid (~2 ms), PCL-equivalent
    storage_downsample: str = "stride"
    # deprecated alias kept for config back-compat: False forces "voxel"
    fast_voxel: bool = True

    def __post_init__(self):
        if self.storage_downsample not in ("stride", "voxel_hash", "voxel"):
            raise ValueError(
                f"storage_downsample must be stride|voxel_hash|voxel, got "
                f"{self.storage_downsample!r}"
            )


@dataclass(frozen=True)
class LoopConfig:
    """Loop-closure detection + verification thresholds."""

    # detection (descriptor-family thresholds live in their own configs)
    intra_enabled: bool = True
    inter_enabled: bool = True
    # ICP verify (reference distributedMapping.h:192,1108-1126)
    history_fitness_score: float = 0.3
    icp_iterations: int = 30
    icp_max_corr_dist: float = 10.0
    # early-exit tolerance on |se3.log(update)| per iteration: 1e-4 is
    # ~0.1 mm / 0.1 mrad per step — far below fitness-gate relevance, and
    # yaw-initialized loops typically reach it in a fraction of the
    # icp_iterations budget (ICP stops there; saves whole NN passes)
    icp_tol: float = 1e-4
    # source points used for ICP correspondence/alignment: the stored
    # keyframe cloud's hash-ordered layout makes a prefix slice a spatially
    # uniform subsample, so 1024 points align as well as 4096 at 4x less cost
    icp_source_points: int = 1024
    # coarse-to-fine ICP: iterate first on every f-th source/target point
    # (1/f^2 of the NN pairs — the NN pass is the whole verification cost),
    # then polish at full resolution from the coarse pose. 1 disables.
    # Fitness is always computed at full resolution.
    icp_coarse_factor: int = 4
    # mid-resolution stage between coarse and full: iterate on every s-th
    # TARGET point (source full) to a loose tolerance, so the full-
    # resolution loop only polishes for a few iterations. The full-
    # resolution stage still runs to icp_tol and fitness is always
    # full-resolution — but the strided problem can park the warm start
    # in a DIFFERENT attractor on partial-overlap loops (measured on the
    # KITTI-density simulator: a corner loop landed 1.9 m away and its
    # fitness crossed the 0.3 gate, 0.268 -> 0.308). Default 1 (off);
    # a throughput knob for dense-overlap deployments, like
    # scan_context.max_bin_points.
    icp_target_stride: int = 1
    # report ICP fitness from the final full-resolution iteration's
    # statistics instead of one more NN pass at the converged pose: the
    # value differs by O(icp_tol x point scale) — orders of magnitude
    # below gate relevance — and saves a whole source x target NN pass
    # per verification (the verify path's unit of cost). Exactness knob:
    # set False to recompute fitness at the exact returned pose.
    icp_reuse_final_fitness: bool = True
    # submap assembly: +-25 keyframes (reference :1163-1186)
    near_keyframes: int = 25
    submap_capacity: int = 8192
    # RANSAC verify, inter-robot (reference :187-189, 1210-1243)
    ransac_max_iter: int = 256           # batched hypotheses (ref: sequential 1000-2000)
    ransac_outlier_threshold: float = 0.25
    ransac_inlier_ratio: float = 0.45
    # queue capacity for pending verified loops
    queue_capacity: int = 256


@dataclass(frozen=True)
class OptimizerConfig:
    """Pose-graph optimization (reference distributedMapping.h:146-153,520-535)."""

    gn_iters: int = 8
    cg_iters: int = 64
    # multilevel preconditioner supernode size: -1 = AUTO (picked from the
    # pose capacity at trace time, graph/solver.py::auto_coarse — long
    # trajectories get the hierarchy without hand-tuning), 0 = block-Jacobi
    # only, >0 = explicit. Needed for long trajectories: block-Jacobi CG
    # takes O(N) iterations to carry a loop correction across an N-pose
    # chain.
    coarse_stride: int = -1
    # >1: additive multilevel (BPX) hierarchy — level l aggregates
    # coarse_stride**l poses; only the coarsest level solves densely. Use
    # when n_poses/coarse_stride is itself too large for a dense Cholesky
    # (10^5+ pose city-scale sessions).
    coarse_levels: int = 1
    damping: float = 1e-6
    huber_delta: float = 1e9             # disabled by default (ref has no robust kernel)
    # noise models as sigmas (rot x3, trans x3); reference expresses these as
    # GTSAM variances: odometry [1e-6 x3, 1e-4 x3], prior
    # [1e-2, 1e-2, pi^2, 1e8 x3] (distributedMapping.h:516-517)
    odometry_sigmas: tuple = (1e-3, 1e-3, 1e-3, 1e-2, 1e-2, 1e-2)
    prior_sigmas: tuple = (0.1, 0.1, 3.14159, 1e4, 1e4, 1e4)
    # loop factor variance = icp fitness * loop_noise_scale (ref uses the raw
    # fitness as the variance, :1146-1159; the scale compensates datasets
    # whose fitness floor is dominated by sampling density)
    loop_noise_scale: float = 1.0
    mapping_process_interval: float = 0.3  # seconds between opts (ref :148,1464)
    edge_capacity: int = 8192
    prior_capacity: int = 8
    # distributed (mesh-attached) solve — consumed by
    # runtime/mapper.py::_drain_queue_and_optimize_mesh when
    # Mapper.attach_mesh() has routed the drain through the two-stage path
    # (parallel/sharded.py::sharded_solve). The reference's
    # distributedOptimizer contract, distributedMapping.h:525-535,878-880.
    max_outer_rounds: int = 10           # GN iteration cap (ref maxIterationTime, :527)
    rotation_change_threshold: float = 0.1  # early-stop |dx_rot| (ref rotThres, :530)
    pose_change_threshold: float = 0.1   # early-stop |dx_trans| (ref poseThres, :531)
    gamma: float = 1.0                   # update over-relaxation (:529)
    use_pcm: bool = False                # ref usePCM default off (:533)
    pcm_threshold: float = 0.75          # (:533)


@dataclass(frozen=True)
class ScanContextParams:
    """reference include/descriptor.h:1307-1330"""

    num_rings: int = 20
    num_sectors: int = 60
    max_radius: float = 80.0
    lidar_height: float = 1.65
    num_candidates: int = 10
    exclude_recent: int = 100
    distance_threshold: float = 0.14
    # cap on raw-scan points entering the max-height binning (0 = all,
    # the reference behavior — and the default: binning from a subsample
    # measurably erodes the gate margin of borderline true revisits at
    # KITTI density, e.g. 0.086 -> 0.117 vs the 0.14 gate at 16384 of a
    # ~115k-pt scan; 8192 loses a true hit outright). Binning cost is
    # points x bins and is the largest non-ICP pipeline term (~29 ms of a
    # 130 ms replay chunk at 64k pts), so throughput-focused deployments
    # can trade: stride decimation of the scan-ordered cloud is
    # azimuth-uniform. Quality impact quantified in
    # tests/test_realistic_proxy.py::TestBinningSubsample.
    max_bin_points: int = 0


@dataclass(frozen=True)
class LidarIrisParams:
    """reference include/descriptor.h:472-509"""

    rows: int = 80
    cols: int = 360
    n_scan: int = 64
    distance_threshold: float = 0.32
    exclude_recent: int = 30
    num_candidates: int = 10
    nscale: int = 4
    min_wave_length: int = 18
    mult: float = 1.6
    sigma_on_f: float = 0.75
    match_mode: int = 2


@dataclass(frozen=True)
class M2DPParams:
    """M2DP signature knobs (reference ``include/descriptor.h:1803-1931``).

    The reference exposes every family's knobs through the param server
    (``distributedMapping.h:156-204``); these four minor-family parameter
    blocks complete that surface (VERDICT r1 §7)."""

    num_t: int = 16
    num_r: int = 8
    num_p: int = 4
    num_q: int = 16
    max_rho: float = 80.0
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 0.25


@dataclass(frozen=True)
class GRSDParams:
    """reference ``include/descriptor.h:38-196``"""

    num_bins: int = 21
    knn: int = 16
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 160.0
    # voxel-transition grid (pcl::GRSDEstimation radius, descriptor.h:90)
    voxel_width: float = 2.0
    extent_xy: float = 80.0
    extent_z: float = 16.0


@dataclass(frozen=True)
class FPFHParams:
    """reference ``include/descriptor.h:253-460``"""

    num_bins: int = 11
    knn: int = 64
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 100.0


@dataclass(frozen=True)
class SHOTParams:
    """reference ``include/descriptor.h:198-251`` (stub there; real here)"""

    azimuth_bins: int = 4
    elevation_bins: int = 2
    radial_bins: int = 2
    cos_bins: int = 5
    max_radius: float = 80.0
    knn: int = 16
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 50.0


@dataclass(frozen=True)
class SlamConfig:
    """Top-level config — the ``paramsServer`` surface."""

    number_of_robots: int = 1
    robot_id: int = 0
    robot_name: str = "a"                # namespace letter 'a'.. (ref :107-114)
    lidar_type: LidarType = LidarType.VELODYNE
    n_scan: int = 64                     # beam count (ref :137-143)
    descriptor_type: DescriptorType = DescriptorType.SCAN_CONTEXT
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scan_context: ScanContextParams = field(default_factory=ScanContextParams)
    lidar_iris: LidarIrisParams = field(default_factory=LidarIrisParams)
    m2dp: M2DPParams = field(default_factory=M2DPParams)
    grsd: GRSDParams = field(default_factory=GRSDParams)
    fpfh: FPFHParams = field(default_factory=FPFHParams)
    shot: SHOTParams = field(default_factory=SHOTParams)
    # observability
    global_map_publish_interval: float = 10.0  # ref mapPublishInterval
    save_directory: str = "/tmp/scl_slam"

    def __post_init__(self):
        if not (1 <= self.number_of_robots <= 26):
            raise ValueError(f"number_of_robots must be 1..26, got {self.number_of_robots}")
        if not (0 <= self.robot_id < self.number_of_robots):
            raise ValueError(
                f"robot_id {self.robot_id} out of range for {self.number_of_robots} robots"
            )
        if len(self.robot_name) != 1 or not self.robot_name.isalpha():
            raise ValueError(f"robot_name must be a single letter, got {self.robot_name!r}")


def _from_dict(cls, data: dict[str, Any]):
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in data.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        ftype = fields[k].type
        if isinstance(v, dict):
            sub = {
                "keyframe": KeyframeConfig,
                "loop": LoopConfig,
                "optimizer": OptimizerConfig,
                "scan_context": ScanContextParams,
                "lidar_iris": LidarIrisParams,
                "m2dp": M2DPParams,
                "grsd": GRSDParams,
                "fpfh": FPFHParams,
                "shot": SHOTParams,
            }[k]
            kwargs[k] = _from_dict(sub, v)
        elif k == "lidar_type":
            kwargs[k] = LidarType(v)
        elif k == "descriptor_type":
            kwargs[k] = DescriptorType(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def load_config(source: str | dict[str, Any]) -> SlamConfig:
    """Load from a YAML file path or a nested dict."""
    if isinstance(source, str):
        import yaml

        with open(source) as f:
            source = yaml.safe_load(f) or {}
    return _from_dict(SlamConfig, source)

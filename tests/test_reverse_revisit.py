"""Opposite-direction (180-deg reversed) revisits through the full pipeline.

BASELINE's config list names KITTI 05+08 specifically to stress
rotation-INVARIANT matching: a reverse loop arrives with the sensor heading
flipped, so retrieval must recover a ~pi yaw (Scan Context all-shift search,
reference ``include/descriptor.h:1491-1569``; LiDAR-Iris FFT template match
+ flip modes, ``:964-1023``) and verification must converge ICP from that
yaw-rotated initialization (``_intra_verify_inputs``). Forward-revisit
coverage lives in tests/test_realistic_proxy.py; this file drives the
REVERSED regime at the same reference-default gates (SC 0.14 / Iris 0.32 /
fitness 0.3), from descriptor margins up to a full drifted-odometry e2e.

Geometry: `UrbanScene.circuit(reverse=True)` traverses the street circuit
the opposite way with heading rotated 180 deg; the revisit lap drives the
OTHER LANE (1 m offset -> ~1.4 m worst-case gap to the nearest stored
keyframe at 2 m spacing). Measured margins at 1024-azimuth density (the
e2e budget), mid-street frames: SC true 0.06-0.11 vs false >= 0.23, with
the shift estimate pinned at 30/60 sectors = 180 deg; Iris true 0.19-0.25
vs the 0.32 gate, recovered yaw within 0.1 rad of pi. Corner/entry frames
degrade (0.18-0.36) exactly as forward lane-offset revisits do — the gate
fires on the useful mid-street fraction, as on real drives.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from scl_slam.config import (
    DescriptorType,
    KeyframeConfig,
    LidarIrisParams,
    LoopConfig,
    OptimizerConfig,
    ScanContextParams,
    SlamConfig,
)
from scl_slam.descriptors import lidar_iris as li
from scl_slam.descriptors import scan_context as sc
from scl_slam.geometry import se3
from scl_slam.io import trajectory as tio
from scl_slam.io.lidar_sim import SENSOR_HEIGHT, LidarSim, UrbanScene
from scl_slam.ops import pointcloud as pc
from scl_slam.runtime import Mapper
from scl_slam.runtime.state import scan_context_config

RAW_CAP = 131072


@pytest.fixture(scope="module")
def world():
    scene = UrbanScene(seed=7, blocks=1, block_size=40.0)
    return scene, LidarSim(scene, n_azimuth=1024)


@pytest.fixture(scope="module")
def laps(world):
    scene, _ = world
    fwd = scene.circuit(lane_offset=0.0, step=2.0)
    rev = scene.circuit(lane_offset=1.0, step=2.0, reverse=True)
    return fwd, rev


def _nearest(rev, T):
    pos_r = np.stack([P[:3, 3] for P in rev])
    return int(np.linalg.norm(pos_r - T[:3, 3], axis=1).argmin())


class TestReverseMargins:
    """Descriptor-level: the reference gates fire on reversed pairs and the
    recovered yaw is ~pi (what seeds ICP across the 180-deg flip)."""

    def test_sc_gate_and_180_shift(self, world, laps):
        _, sim = world
        fwd, rev = laps
        scc = scan_context_config(
            SlamConfig(scan_context=ScanContextParams(lidar_height=SENSOR_HEIGHT))
        )
        dists, shifts = [], []
        for i in (40, 55, 70, 85):
            j = _nearest(rev, fwd[i])
            a = sc.make(pc.from_points(sim.scan_at(fwd[i], seed=i), RAW_CAP), scc)
            b = sc.make(
                pc.from_points(sim.scan_at(rev[j], seed=5000 + j), RAW_CAP), scc
            )
            d, s = sc.shifted_cosine_distance(a.image, b.image[None])
            dists.append(float(d[0]))
            shifts.append(int(s[0]))
        # REFERENCE gate 0.14, unmodified; all four mid-street pairs pass
        assert all(d < 0.14 for d in dists), dists
        # the all-shift search localizes the flip: 30 of 60 sectors = pi
        assert all(abs(s - 30) <= 1 for s in shifts), shifts
        # false pairs (distinct forward corners) stay above the gate
        for a_i, b_i in [(10, 55), (25, 85)]:
            a = sc.make(
                pc.from_points(sim.scan_at(fwd[a_i], seed=a_i), RAW_CAP), scc
            )
            b = sc.make(
                pc.from_points(sim.scan_at(fwd[b_i], seed=b_i), RAW_CAP), scc
            )
            d, _ = sc.shifted_cosine_distance(a.image, b.image[None])
            assert float(d[0]) > 0.14, (a_i, b_i, float(d[0]))

    def test_iris_gate_and_pi_yaw(self, world, laps):
        _, sim = world
        fwd, rev = laps
        icfg = li.LidarIrisConfig()  # reference defaults, match_mode=2
        for i in (40, 70, 85):
            j = _nearest(rev, fwd[i])
            a = li.make(pc.from_points(sim.scan_at(fwd[i], seed=i), RAW_CAP), icfg)
            b = li.make(
                pc.from_points(sim.scan_at(rev[j], seed=5000 + j), RAW_CAP), icfg
            )
            d, yaw = li.match_pair(a.image, b.image, icfg)
            assert float(d) < 0.32, (i, float(d))  # REFERENCE gate
            assert abs(abs(float(yaw)) - np.pi) < 0.15, (i, float(yaw))


def _drive(cfg, sim, gt, drift_seed=3):
    """Drifted-odometry pipeline run; returns (loop events, est, dead, gt_kf).

    Random-walk odometry noise at the realistic-proxy e2e's sigmas; the
    simulated clock drives the drain cadence deterministically."""
    m = Mapper(cfg)
    rng = np.random.RandomState(drift_seed)
    odom = [
        se3.Pose(
            jnp.asarray(gt[0][:3, :3], jnp.float32),
            jnp.asarray(gt[0][:3, 3], jnp.float32),
        )
    ]
    for k in range(1, len(gt)):
        inc_np = np.linalg.inv(gt[k - 1]) @ gt[k]
        noise = se3.exp(
            jnp.asarray(
                np.concatenate([rng.randn(3) * 0.002, rng.randn(3) * 0.02]),
                jnp.float32,
            )
        )
        inc = se3.Pose(
            jnp.asarray(inc_np[:3, :3], jnp.float32),
            jnp.asarray(inc_np[:3, 3], jnp.float32),
        )
        odom.append(se3.compose(odom[-1], se3.compose(inc, noise)))

    events = []
    for k in range(len(gt)):
        scan = sim.scan_at(gt[k], seed=k)
        wire = m.add_frame(odom[k], scan, stamp=float(k))
        if wire is not None:
            info = m.spin_once(now=1.0 * k)
            if info.get("loop"):
                events.append(info["loop"])
    m.optimize()
    est = m.trajectory()
    kf_idx = [int(round(float(s))) for s in m.keyframe_stamps()]
    gt_kf = np.stack([gt[i] for i in kf_idx])
    dead = np.stack([np.asarray(se3.to_matrix(p)) for p in odom])[kf_idx]
    return events, est, dead, gt_kf


class TestReverseE2E:
    """Full pipeline: forward lap + reversed other-lane lap, reference
    gates untouched — reversed loops close (yaw ~ pi in the events) and
    the drain corrects drifted odometry."""

    def test_sc_reverse_loops_close_and_correct_drift(self, world, laps):
        _, sim = world
        fwd, rev = laps
        gt = fwd + rev
        cfg = SlamConfig(
            keyframe=KeyframeConfig(
                max_keyframes=512, points_per_keyframe=8192,
                raw_points_capacity=RAW_CAP, distance_threshold=1.0,
            ),
            loop=LoopConfig(
                near_keyframes=6, submap_capacity=16384,
                history_fitness_score=0.3, icp_iterations=30,
                icp_max_corr_dist=10.0,
            ),
            optimizer=OptimizerConfig(edge_capacity=2048, gn_iters=5, cg_iters=32),
            scan_context=ScanContextParams(lidar_height=SENSOR_HEIGHT),
        )
        events, est, dead, gt_kf = _drive(cfg, sim, gt)
        # loops close through the 0.14/0.3 gates on the reversed lap
        assert len(events) >= 3, f"only {len(events)} reversed loops"
        # and they really are REVERSED matches: the retrieval yaw is ~pi
        yaws = [abs(e["yaw"]) for e in events]
        assert max(yaws) > np.pi - 0.35, yaws
        ate = tio.ate_rmse(est, gt_kf, align=False)
        ate_dead = tio.ate_rmse(dead, gt_kf, align=False)
        assert ate_dead > 0.5
        assert ate < 0.9 * ate_dead, f"ATE {ate:.3f} vs dead {ate_dead:.3f}"

    def test_iris_reverse_loops_close(self, world, laps):
        _, sim = world
        fwd, rev = laps
        gt = fwd + rev
        cfg = SlamConfig(
            descriptor_type=DescriptorType.LIDAR_IRIS,
            keyframe=KeyframeConfig(
                max_keyframes=512, points_per_keyframe=8192,
                raw_points_capacity=RAW_CAP, distance_threshold=1.0,
            ),
            loop=LoopConfig(
                near_keyframes=6, submap_capacity=16384,
                history_fitness_score=0.3, icp_iterations=30,
                icp_max_corr_dist=10.0,
            ),
            optimizer=OptimizerConfig(edge_capacity=2048, gn_iters=5, cg_iters=32),
            lidar_iris=LidarIrisParams(),  # reference defaults: 0.32, mode 2
        )
        events, est, dead, gt_kf = _drive(cfg, sim, gt)
        # Iris's translation sensitivity (documented in its paper and in
        # tests/test_iris_realistic.py) leaves fewer reversed frames under
        # the 0.32 gate than SC's 0.14 at the ~1.4 m revisit gaps here —
        # measured: ONE reversed loop closes (matched_index 49, yaw 3.089,
        # fitness 0.290 through the unmodified 0.3 gate)
        assert len(events) >= 1, "iris closed no reversed loop"
        yaws = [abs(e["yaw"]) for e in events]
        assert max(yaws) > np.pi - 0.35, yaws
        ate = tio.ate_rmse(est, gt_kf, align=False)
        ate_dead = tio.ate_rmse(dead, gt_kf, align=False)
        assert ate < ate_dead, f"ATE {ate:.3f} vs dead {ate_dead:.3f}"

"""End-to-end single-robot SLAM pipeline on a synthetic world.

The analog of the reference's bag-replay integration runs
(``launch/test_distributed_loop.launch`` with numberOfRobots=1) without ROS:
simulated LiDAR scans + drifting odometry in, optimized trajectory out,
scored by ATE against ground truth.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scl_slam.config import (
    KeyframeConfig,
    LoopConfig,
    OptimizerConfig,
    ScanContextParams,
    SlamConfig,
)
from scl_slam.geometry import se3
from scl_slam.io import kitti, trajectory as tio
from scl_slam.runtime import Mapper


SCAN_POINTS = 4096
# fitness gate: mean-sq NN distance has a sampling-density floor; the synthetic
# world at these capacities floors near 3 m^2 for true loops vs 15+ for false
# (KITTI-density clouds use the reference's 0.3 default)
FITNESS_GATE = 8.0


def small_cfg(**kw):
    return SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=128,
            points_per_keyframe=2048,
            raw_points_capacity=4096,
            distance_threshold=2.0,
            descript_leaf_size=0.3,
        ),
        loop=LoopConfig(
            near_keyframes=6,
            submap_capacity=8192,
            icp_iterations=25,
            history_fitness_score=FITNESS_GATE,
        ),
        optimizer=OptimizerConfig(edge_capacity=512, gn_iters=6, cg_iters=48),
        # surface-sampled synthetic scans at 4k points/bin are noisier than
        # dense real scans: 0.25 matches SC-LIO-SAM's shipped threshold
        # (reference code default is 0.14 for full-density scans)
        scan_context=ScanContextParams(
            exclude_recent=15, num_candidates=6, distance_threshold=0.25
        ),
        **kw,
    )


N_FRAMES = 72


@pytest.fixture(scope="module")
def sim():
    world = kitti.SyntheticWorld(
        seed=3, extent=120.0, n_clusters=80, pts_per_cluster=800
    )
    gt = kitti.loop_trajectory(n_frames=N_FRAMES, radius=40.0, revisit=True)
    return world, gt


@pytest.fixture(scope="module")
def clean_run(sim):
    """One drift-free pipeline run shared by several tests (CPU is slow)."""
    world, gt = sim
    return run_pipeline(small_cfg(), world, gt, [0.0] * 6)


def drifting_odometry(gt, drift_per_frame):
    """Odometry poses accumulating a constant twist drift per frame."""
    drift = se3.exp(jnp.asarray(drift_per_frame, jnp.float32))
    poses = [se3.Pose(jnp.asarray(gt[0][:3, :3], jnp.float32), jnp.asarray(gt[0][:3, 3], jnp.float32))]
    for k in range(1, len(gt)):
        inc_np = np.linalg.inv(gt[k - 1]) @ gt[k]
        inc = se3.Pose(
            jnp.asarray(inc_np[:3, :3], jnp.float32),
            jnp.asarray(inc_np[:3, 3], jnp.float32),
        )
        poses.append(se3.compose(poses[-1], se3.compose(inc, drift)))
    return poses


def run_pipeline(cfg, world, gt, drift):
    m = Mapper(cfg)
    odom = drifting_odometry(gt, drift)
    loops = []
    for k in range(len(gt)):
        scan = world.scan_at(gt[k], max_points=SCAN_POINTS, seed=k)
        wire = m.add_frame(odom[k], scan, stamp=0.1 * k)
        if wire is not None:
            info = m.spin_once()
            if info.get("loop"):
                loops.append((k, info["loop"]))
    m.optimize()
    return m, loops


class TestEndToEnd:
    def test_no_drift_stays_consistent(self, sim, clean_run):
        world, gt = sim
        m, _ = clean_run
        est = m.trajectory()
        n = len(est)
        assert n > 30  # keyframe gate kept a sensible fraction of the frames
        # match keyframes to gt by stamp (gate applied to gt-equal odometry)
        stamps = m.keyframe_stamps()
        kf_gt = [gt[int(round(float(s) / 0.1))] for s in stamps]
        ate = tio.ate_rmse(est, np.stack(kf_gt), align=False)
        assert ate < 0.5

    def test_loops_found_and_drift_corrected(self, sim):
        import dataclasses

        world, gt = sim
        drift = [0, 0, 0.0015, 0.035, 0.0, 0.0]  # yaw + forward drift
        cfg = small_cfg()
        # honest odometry noise (the reference's 1e-3/1e-2 sigmas claim far
        # less drift than we inject) + loop variance normalized for the
        # synthetic sampling-density fitness floor
        cfg = dataclasses.replace(
            cfg,
            optimizer=dataclasses.replace(
                cfg.optimizer,
                odometry_sigmas=(0.005, 0.005, 0.005, 0.05, 0.05, 0.05),
                loop_noise_scale=0.02,
            ),
        )
        m, loops = run_pipeline(cfg, world, gt, drift)
        assert len(loops) >= 1, "revisit segment must produce intra loops"
        est = m.trajectory()
        stamps = m.keyframe_stamps()
        frame_ids = [int(round(float(s) / 0.1)) for s in stamps]
        kf_gt = np.stack([gt[k] for k in frame_ids])
        ate_opt = tio.ate_rmse(est, kf_gt)

        # dead reckoning baseline directly from the drifted odometry
        odom = drifting_odometry(gt, drift)
        dead = np.stack(
            [np.asarray(se3.to_matrix(odom[k])) for k in frame_ids]
        )
        ate_dead = tio.ate_rmse(dead, kf_gt)
        assert ate_opt < ate_dead * 0.7, (
            f"loop closure must materially reduce ATE: {ate_opt} vs {ate_dead}"
        )

    def test_trajectory_export_roundtrip(self, clean_run, tmp_path):
        m, _ = clean_run
        m.save_trajectories(str(tmp_path))
        poses, stamps = tio.load_tum(str(tmp_path / "a_tum.txt"))
        est = m.trajectory()
        assert len(poses) == len(est)
        np.testing.assert_allclose(poses[:, :3, 3], est[:, :3, 3], atol=1e-4)
        kitti_rows = np.loadtxt(tmp_path / "a_kitti.txt")
        assert kitti_rows.shape == (len(est), 12)

    def test_global_map_nonempty(self, clean_run):
        m, _ = clean_run
        gmap = m.global_map()
        assert len(gmap) > 1000
        assert np.all(np.isfinite(gmap))

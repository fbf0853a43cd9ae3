"""IMU-fused odometry front end (runtime/odometry.py::ImuFusedOdometry):
scan-to-map ICP + 15-state sliding-window smoother, the in-framework
equivalent of the reference's LIO-SAM front end.

IMU data comes from test_imu_factor.simulate — ground truth integrated with
the same discretization the preintegrator uses, so the measurement model is
exact and tests check estimation, not synthesizer artifacts.
"""
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3
from scl_slam.io import kitti
from scl_slam.runtime import imu as imu_mod
from scl_slam.runtime.odometry import ImuFusedOdometry, OdometryConfig

from test_imu_factor import simulate


def poses_4x4(gt):
    R = np.asarray(gt.R)
    p = np.asarray(gt.p)
    out = np.tile(np.eye(4), (len(p), 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = p
    return out


class TestImuFusedOdometry:
    def test_tracks_trajectory_past_window(self):
        n = 16
        gt, data, rel = simulate(n_states=n, m=20, h=0.01, seed=2)
        Ts = poses_4x4(gt)
        world = kitti.SyntheticWorld(
            seed=11, extent=60.0, n_clusters=60, pts_per_cluster=600,
            max_range=50.0,
        )
        fused = ImuFusedOdometry(
            OdometryConfig(map_capacity=16384, scan_capacity=2048,
                           icp_iters=10, scan_leaf=0.3, max_corr_dist=2.0),
            window=6, max_samples=32,
        )
        errs, infos = [], []
        for k in range(n):
            scan = world.scan_at(Ts[k], max_points=4096, seed=k)
            if k == 0:
                acc = np.zeros((1, 3), np.float32)
                gyr = np.zeros((1, 3), np.float32)
                dt = np.zeros((1,), np.float32)
            else:
                acc = np.asarray(data.accel[k - 1])
                gyr = np.asarray(data.gyro[k - 1])
                dt = np.asarray(data.dt[k - 1])
            pose, fit, info = fused.step(scan, acc, gyr, dt)
            # odometry frame = frame of Ts[0]
            gt_rel = np.linalg.inv(Ts[0]) @ Ts[k]
            errs.append(float(np.linalg.norm(np.asarray(pose.t) - gt_rel[:3, 3])))
            infos.append(info)
        # 16 frames > 6-node window: sliding exercised; tracking holds
        assert max(errs) < 0.5, errs
        # ground-truth velocities are known exactly (world frame, ~1 m/s);
        # compare the last smoothed velocity against truth
        v_est = infos[-1]["velocity"]
        v_gt = np.asarray(gt.v[-1])
        assert np.isfinite(v_est).all()
        assert np.linalg.norm(v_est - v_gt) < 0.5, (v_est, v_gt)

    def test_fast_trajectory_velocity_seeding(self):
        """5 m/s circular sweep with synthesized (approximately-consistent)
        IMU: without finite-difference velocity seeding the smoother
        linearizes at v=0, far outside the GN basin, and tears good ICP
        poses apart (measured 10 m blow-ups). With seeding + the divergence
        gate, tracking stays tight and velocity converges to truth."""
        gt = kitti.loop_trajectory(n_frames=126, radius=20.0, revisit=False)
        world = kitti.SyntheticWorld(
            seed=3, extent=60.0, n_clusters=60, pts_per_cluster=600,
            max_range=50.0,
        )
        fused = ImuFusedOdometry(
            OdometryConfig(map_capacity=16384, scan_capacity=2048,
                           icp_iters=10, scan_leaf=0.3, max_corr_dist=2.0),
            window=6, max_samples=32,
        )
        errs = []
        for k in range(20):
            scan = world.scan_at(gt[k], max_points=4096, seed=k)
            if k == 0:
                acc = np.zeros((1, 3), np.float32)
                gyr = np.zeros((1, 3), np.float32)
                dt = np.zeros((1,), np.float32)
            else:
                acc, gyr, dt = imu_mod.synthesize_between_frames(
                    gt[k - 1], gt[k], 20, 0.01
                )
            pose, _, info = fused.step(scan, acc, gyr, dt)
            rel = np.linalg.inv(gt[0]) @ gt[k]
            errs.append(float(np.linalg.norm(np.asarray(pose.t) - rel[:3, 3])))
        assert max(errs) < 0.5, errs
        v_truth = np.linalg.norm(gt[1][:3, 3] - gt[0][:3, 3]) / 0.2
        assert abs(np.linalg.norm(info["velocity"]) - v_truth) < 0.5

    def test_gyro_bias_observable_from_synthesized_twists(self):
        """Constant-twist synthesized IMU (runtime/imu.py helper) has an
        exact rotation channel; with accel down-weighted, the smoother
        recovers an injected gyro bias from exact relative poses."""
        gt = kitti.loop_trajectory(n_frames=80, radius=25.0, revisit=False)[:10]
        bias = np.array([0.02, -0.01, 0.015], np.float32)
        from scl_slam.graph import imu_factor as IF

        sm = IF.ImuSmoother(
            window=10, max_samples=32,
            cfg=IF.ImuFactorConfig(prior_bias_sigma=1.0, accel_noise=10.0),
        )
        T0 = gt[0]
        sm.set_node_pose(0, T0[:3, :3], T0[:3, 3])
        for k in range(9):
            acc, gyr, dt = imu_mod.synthesize_between_frames(
                gt[k], gt[k + 1], 20, 0.01
            )
            gyr = gyr + bias
            rel = np.linalg.inv(gt[k]) @ gt[k + 1]
            sm.push_interval(acc, gyr, dt, se3.Pose(
                jnp.asarray(rel[:3, :3], jnp.float32),
                jnp.asarray(rel[:3, 3], jnp.float32)))
            Tk = gt[k + 1]
            sm.set_node_pose(k + 1, Tk[:3, :3], Tk[:3, 3])
        states, chis = sm.solve(gn_iters=8)
        bg = np.asarray(states.bg[-1])
        np.testing.assert_allclose(bg, bias, atol=5e-3)

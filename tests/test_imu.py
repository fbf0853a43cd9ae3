import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3, so3
from scl_slam.io import kitti
from scl_slam.runtime import imu
from scl_slam.runtime.odometry import Odometry, OdometryConfig


def pose_mat(R, t):
    T = np.eye(4)
    T[:3, :3] = np.asarray(R)
    T[:3, 3] = np.asarray(t)
    return T


class TestPreintegration:
    def test_rotation_integration_matches_relative(self):
        # constant-twist motion; preintegrated delta_R must equal rel rotation
        T0 = pose_mat(np.eye(3), [0, 0, 0])
        R1 = np.asarray(so3.exp(jnp.array([0.02, -0.05, 0.3])))
        T1 = pose_mat(R1, [1.0, 0.5, 0.0])
        acc, gyro, dt = imu.synthesize_between_frames(T0, T1, 100, 0.001)
        pre = imu.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dt))
        np.testing.assert_allclose(np.asarray(pre.delta_R), R1, atol=2e-3)
        assert int(pre.count) == 100
        np.testing.assert_allclose(float(pre.dt_total), 0.1, atol=1e-6)

    def test_invalid_samples_ignored(self):
        gyro = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (10, 1))
        dt = jnp.full(10, 0.01).at[5:].set(-1.0)  # only 5 valid samples
        pre = imu.preintegrate(jnp.zeros((10, 3)), gyro, dt)
        assert int(pre.count) == 5
        w = so3.log(pre.delta_R)
        np.testing.assert_allclose(np.asarray(w), [0, 0, 0.05], atol=1e-5)

    def test_gyro_bias_removed(self):
        bias = jnp.array([0.01, -0.02, 0.005])
        gyro = jnp.tile(bias, (50, 1))  # pure bias -> zero rotation
        dt = jnp.full(50, 0.01)
        R = imu.gyro_delta_rotation(gyro, dt, gyro_bias=bias)
        np.testing.assert_allclose(np.asarray(R), np.eye(3), atol=1e-6)


class TestGyroAidedOdometry:
    def test_gyro_seed_accepted(self):
        # smoke: the gyro-seeded path runs end-to-end and stays accurate
        world = kitti.SyntheticWorld(
            seed=21, extent=80.0, n_clusters=60, pts_per_cluster=600, max_range=50.0
        )
        gt = kitti.loop_trajectory(n_frames=80, radius=25.0, revisit=False)[:15]
        odo = Odometry(OdometryConfig(
            map_capacity=16384, scan_capacity=2048, icp_iters=10,
            scan_leaf=0.4, max_corr_dist=3.0,
        ))
        errs = []
        for k in range(15):
            scan = world.scan_at(gt[k], max_points=4096, seed=k)
            if k == 0:
                pose, _ = odo.step(scan)
            else:
                acc, gyro, dt = imu.synthesize_between_frames(
                    gt[k - 1], gt[k], 50, 0.002
                )
                pose, _ = odo.step(scan, gyro=gyro, imu_dt=dt)
            rel_gt = np.linalg.inv(gt[0]) @ gt[k]
            errs.append(np.linalg.norm(np.asarray(pose.t) - rel_gt[:3, 3]))
        assert errs[-1] < 1.5, f"gyro-aided odometry drift {errs[-1]:.2f} m"

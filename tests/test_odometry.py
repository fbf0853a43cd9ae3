import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3
from scl_slam.io import kitti
from scl_slam.ops import pointcloud as pc, registration as reg
from scl_slam.runtime.odometry import Odometry, OdometryConfig


class TestPointToPlane:
    def test_recovers_transform_on_plane_scene(self):
        # structured scene: three orthogonal planes (floor + 2 walls)
        rng = np.random.RandomState(0)
        floor = np.column_stack(
            [rng.uniform(-20, 20, 2000), rng.uniform(-20, 20, 2000), np.zeros(2000)]
        )
        wall1 = np.column_stack(
            [rng.uniform(-20, 20, 1000), np.full(1000, 10.0), rng.uniform(0, 5, 1000)]
        )
        wall2 = np.column_stack(
            [np.full(1000, -15.0), rng.uniform(-20, 20, 1000), rng.uniform(0, 5, 1000)]
        )
        scene = np.concatenate([floor, wall1, wall2]).astype(np.float32)
        target = pc.from_points(scene, 4096)
        normals = pc.estimate_normals(target, k=12)

        gt = se3.Pose(
            se3.so3.exp(jnp.array([0.01, -0.02, 0.05])), jnp.array([0.3, -0.2, 0.1])
        )
        src_pts = se3.transform_points(se3.inverse(gt), target.xyz[:4000])
        source = pc.from_points(np.asarray(src_pts), 4096)
        res = reg.icp_point_to_plane(source, target, normals, max_iters=15)
        np.testing.assert_allclose(np.asarray(res.pose.R), np.asarray(gt.R), atol=2e-3)
        np.testing.assert_allclose(np.asarray(res.pose.t), np.asarray(gt.t), atol=5e-2)
        assert float(res.fitness) < 1e-3


class TestOdometry:
    def test_tracks_synthetic_trajectory(self):
        world = kitti.SyntheticWorld(
            seed=11, extent=80.0, n_clusters=60, pts_per_cluster=600, max_range=50.0
        )
        # ~2 m frame spacing (sensor-rate scale; at 5+ m/frame ICP's
        # correspondence gate can't bridge the prediction error)
        gt = kitti.loop_trajectory(n_frames=80, radius=25.0, revisit=False)[:30]
        odo = Odometry(OdometryConfig(
            map_capacity=16384, scan_capacity=2048, icp_iters=10,
            scan_leaf=0.4, max_corr_dist=3.0,
        ))
        est = []
        for k in range(30):
            scan = world.scan_at(gt[k], max_points=4096, seed=k)
            pose, fit = odo.step(scan)
            est.append(np.asarray(se3.to_matrix(pose)))
        est = np.stack(est)
        # odometry frame starts at identity; gt starts at gt[0]; compare
        # relative motion: est is in frame of gt[0]
        gt_rel = np.stack([np.linalg.inv(gt[0]) @ g for g in gt])
        err = np.linalg.norm(est[:, :3, 3] - gt_rel[:, :3, 3], axis=1)
        # drift allowance: < 2% of ~100 m traveled
        assert err[-1] < 2.0, f"final drift {err[-1]:.2f} m"
        assert err.max() < 3.0

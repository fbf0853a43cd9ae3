"""Scan deskewing (ops/deskew.py) and its front-end wiring.

The reference's front ends all motion-compensate
(``launch/single_ugv.launch:33-39`` selects FAST-LIO/LIO-SAM variants,
each of which deskews before registration); these tests pin the JAX
equivalent: exact constant-twist inversion, gyro-trajectory agreement,
simulator round-trip, and odometry accuracy recovery on skewed sweeps.
"""
import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3, so3
from scl_slam.io import lidar_sim
from scl_slam.ops import deskew as dsk
from scl_slam.runtime.odometry import Odometry, OdometryConfig


def _random_twist(rng, rot=0.3, trans=1.5):
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * rot
    v = rng.normal(size=3) * trans
    return jnp.asarray(np.concatenate([w, v]), jnp.float32)


class TestConstantTwist:
    def test_exact_inversion(self):
        """Points smeared by a known constant twist come back exactly."""
        rng = np.random.default_rng(0)
        n = 512
        p_world = jnp.asarray(rng.normal(size=(n, 3)) * 10, jnp.float32)
        tau = jnp.asarray(rng.uniform(size=n), jnp.float32)
        xi = _random_twist(rng)
        # sensor pose at tau: T(tau) = exp(tau*xi); measured coords are
        # the world point in the capture-time frame
        T_tau = se3.exp(tau[:, None] * xi[None, :])
        meas = jnp.einsum(
            "nji,nj->ni", T_tau.R, p_world - T_tau.t
        )  # T(tau)^{-1} p
        mask = jnp.ones(n, bool)
        out = dsk.deskew_constant_twist(
            meas, mask, tau, se3.exp(xi)
        )
        # expected: world point in the sweep-end frame T(1)^{-1} p
        T1 = se3.exp(xi)
        want = jnp.einsum("ji,nj->ni", T1.R, p_world - T1.t[None, :])
        np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                                   atol=2e-4)

    def test_identity_motion_noop(self):
        rng = np.random.default_rng(1)
        xyz = jnp.asarray(rng.normal(size=(64, 3)), jnp.float32)
        mask = jnp.ones(64, bool)
        tau = jnp.asarray(rng.uniform(size=64), jnp.float32)
        out = dsk.deskew_constant_twist(xyz, mask, tau, se3.identity())
        np.testing.assert_allclose(np.asarray(out), np.asarray(xyz),
                                   atol=1e-5)

    def test_masked_points_padded(self):
        xyz = jnp.zeros((8, 3), jnp.float32)
        mask = jnp.asarray([True] * 4 + [False] * 4)
        tau = jnp.full(8, 0.5, jnp.float32)
        out = dsk.deskew_constant_twist(
            xyz, mask, tau, se3.exp(jnp.asarray([0, 0, 0.3, 1, 0, 0.0]))
        )
        assert np.all(np.asarray(out)[4:] == 1e6)

    def test_azimuth_times_span(self):
        az = np.linspace(-np.pi + 1e-3, np.pi - 1e-3, 100)
        xyz = jnp.asarray(
            np.stack([np.cos(az), np.sin(az), np.zeros_like(az)], -1),
            jnp.float32,
        )
        t = np.asarray(dsk.azimuth_sweep_times(xyz, jnp.ones(100, bool)))
        assert t[0] < 0.01 and t[-1] > 0.99
        assert np.all(np.diff(t) > 0)
        t_cw = np.asarray(
            dsk.azimuth_sweep_times(xyz, jnp.ones(100, bool), clockwise=True)
        )
        np.testing.assert_allclose(t_cw, 1.0 - t, atol=1e-6)


class TestGyroDeskew:
    def test_matches_constant_twist_for_constant_rate(self):
        """With a constant body rate the gyro trajectory IS the constant
        twist — both paths must agree (pure rotation)."""
        rng = np.random.default_rng(2)
        n = 256
        xyz = jnp.asarray(rng.normal(size=(n, 3)) * 5, jnp.float32)
        mask = jnp.ones(n, bool)
        tau = jnp.asarray(rng.uniform(size=n), jnp.float32)
        w = np.asarray([0.0, 0.0, 0.5])  # rad over the sweep
        m = 64
        gyro = jnp.asarray(np.tile(w * 10.0, (m, 1)), jnp.float32)  # 0.1s sweep
        dt = jnp.full(m, 0.1 / m, jnp.float32)
        Rs, tf = dsk.gyro_rotation_samples(gyro, dt)
        out_g = dsk.deskew_gyro(xyz, mask, tau, Rs, tf, jnp.zeros(3))
        motion = se3.Pose(so3.exp(jnp.asarray(w, jnp.float32)), jnp.zeros(3))
        out_c = dsk.deskew_constant_twist(xyz, mask, tau, motion)
        # piecewise-constant rotation sampling: error bounded by one
        # sample's rotation (~0.5/64 rad on 10 m points)
        err = np.linalg.norm(np.asarray(out_g) - np.asarray(out_c), axis=-1)
        assert np.max(err) < 0.12, np.max(err)

    def test_padded_samples_ignored(self):
        gyro = jnp.asarray(
            np.concatenate([np.tile([0, 0, 5.0], (32, 1)),
                            np.full((32, 3), 99.0)]), jnp.float32)
        dt = jnp.concatenate([jnp.full(32, 0.1 / 32), jnp.zeros(32)])
        Rs, tf = dsk.gyro_rotation_samples(gyro, dt)
        # final rotation = 0.5 rad yaw regardless of the garbage pads
        want = so3.exp(jnp.asarray([0.0, 0.0, 0.5]))
        np.testing.assert_allclose(np.asarray(Rs[-1]), np.asarray(want),
                                   atol=1e-5)
        assert abs(float(tf[-1]) - 1.0) < 1e-6


class TestSimulatorRoundTrip:
    def test_deskewed_scan_matches_static(self):
        """Simulator-smeared sweep + deskew ~= static scan at sweep end."""
        scene = lidar_sim.UrbanScene(seed=3)
        sim = lidar_sim.LidarSim(scene, n_azimuth=360)
        circuit = scene.circuit(step=1.0)
        T0, T1 = circuit[10], circuit[13]  # 3 m + heading change in-sweep
        # make the motion rotational too: yaw the end pose a bit
        yaw = 0.12
        Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                       [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        T1 = T1.copy()
        T1[:3, :3] = T1[:3, :3] @ Rz

        skewed = sim.scan_at_skewed(T0, T1, seed=7)
        static = sim.scan_at(T1, seed=7)

        motion = np.linalg.inv(T0) @ T1
        mpose = se3.Pose(jnp.asarray(motion[:3, :3], jnp.float32),
                         jnp.asarray(motion[:3, 3], jnp.float32))
        mask = jnp.ones(len(skewed), bool)
        tau = dsk.azimuth_sweep_times(jnp.asarray(skewed), mask)
        fixed = np.asarray(dsk.deskew_constant_twist(
            jnp.asarray(skewed), mask, tau, mpose))

        def p90_nn(a, b):
            # 90th-percentile nearest-neighbor distance a -> b (chunked)
            b = jnp.asarray(b)
            ds = []
            for i in range(0, len(a), 2048):
                d2 = jnp.sum(
                    (jnp.asarray(a[i:i + 2048])[:, None] - b[None]) ** 2, -1)
                ds.append(np.asarray(jnp.sqrt(d2.min(axis=1))))
            return float(np.percentile(np.concatenate(ds), 90))

        # ground returns are POSE-INVARIANT in the sensor frame (flat
        # plane + constant sensor height), so they can't witness the
        # smear — measure on building/pole points only
        ng_skew = skewed[skewed[:, 2] > -1.2][::5]
        ng_fix = fixed[fixed[:, 2] > -1.2][::5]
        d_skew = p90_nn(ng_skew, static)
        d_fix = p90_nn(ng_fix, static)
        # raw smear is ~1 m at p90; deskew brings it near range noise
        assert d_fix < 0.2, (d_skew, d_fix)
        assert d_fix < d_skew / 4, (d_skew, d_fix)


class TestOdometryRecovery:
    def test_ate_recovery_on_skewed_sweeps(self):
        """Odometry on motion-smeared sweeps: deskew='const' must beat
        deskew='none' and land near the ground truth."""
        scene = lidar_sim.UrbanScene(seed=4)
        sim = lidar_sim.LidarSim(scene, n_azimuth=360)
        circuit = scene.circuit(step=2.0)[:18]  # fast: 2 m/frame + corner
        scans = [
            sim.scan_at_skewed(
                circuit[max(k - 1, 0)], circuit[k], seed=100 + k
            )
            for k in range(len(circuit))
        ]
        cfg = dict(map_capacity=16384, scan_capacity=2048, icp_iters=8)

        # odometry starts at identity; compare drift in the relative frame
        def run_ate(deskew):
            odo = Odometry(OdometryConfig(deskew=deskew, **cfg))
            T0 = circuit[0]
            errs = []
            for k, s in enumerate(scans):
                pose, _ = odo.step(s)
                gt_rel = np.linalg.inv(T0) @ circuit[k]
                errs.append(
                    np.linalg.norm(np.asarray(pose.t) - gt_rel[:3, 3])
                )
            return float(np.sqrt(np.mean(np.square(errs))))

        ate_raw = run_ate("none")
        ate_fix = run_ate("const")
        assert ate_fix < ate_raw * 0.7, (ate_raw, ate_fix)
        assert ate_fix < 0.6, (ate_raw, ate_fix)

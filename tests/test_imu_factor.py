"""15-state IMU window smoother (graph/imu_factor.py).

The simulator integrates ground truth with the SAME Euler scheme the
preintegrator uses, so the measurement model is exact and the tests check
estimation (bias/velocity observability), not discretization error.
"""
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3
from scl_slam.graph import imu_factor as IF

G = np.array([0.0, 0.0, -9.81])


def simulate(n_states=6, m=20, h=0.01, seed=0, bg=None, ba=None):
    """Returns (gt: ImuStates arrays, data: ImuWindowData, rel poses)."""
    rng = np.random.RandomState(seed)
    R = np.eye(3)
    p = np.zeros(3)
    v = np.array([1.0, 0.0, 0.0])
    bg = np.zeros(3) if bg is None else np.asarray(bg)
    ba = np.zeros(3) if ba is None else np.asarray(ba)
    Rs, ps, vs = [R.copy()], [p.copy()], [v.copy()]
    accel = np.zeros((n_states - 1, m, 3), np.float32)
    gyro = np.zeros((n_states - 1, m, 3), np.float32)
    dts = np.full((n_states - 1, m), h, np.float32)
    from scl_slam.geometry import so3 as so3m

    for i in range(n_states - 1):
        w = rng.uniform(-0.4, 0.4, 3)
        f_drive = rng.uniform(-0.8, 0.8, 3)
        for s in range(m):
            f = f_drive - R.T @ G          # specific force (bias-free)
            a_w = R @ f + G                # = R @ f_drive
            p = p + v * h + 0.5 * a_w * h * h
            v = v + a_w * h
            R = R @ np.asarray(so3m.exp(jnp.asarray(w * h)))
            accel[i, s] = f + ba
            gyro[i, s] = w + bg
        Rs.append(R.copy())
        ps.append(p.copy())
        vs.append(v.copy())

    gt = IF.ImuStates(
        R=jnp.asarray(np.stack(Rs), jnp.float32),
        p=jnp.asarray(np.stack(ps), jnp.float32),
        v=jnp.asarray(np.stack(vs), jnp.float32),
        bg=jnp.tile(jnp.asarray(bg, jnp.float32), (n_states, 1)),
        ba=jnp.tile(jnp.asarray(ba, jnp.float32), (n_states, 1)),
    )
    data = IF.ImuWindowData(
        jnp.asarray(accel), jnp.asarray(gyro), jnp.asarray(dts)
    )
    poses = se3.Pose(gt.R, gt.p)
    rel = se3.between(
        se3.Pose(gt.R[:-1], gt.p[:-1]), se3.Pose(gt.R[1:], gt.p[1:])
    )
    return gt, data, rel


CFG = IF.ImuFactorConfig(prior_vel_sigma=10.0, prior_bias_sigma=1.0)


class TestImuFactor:
    def test_ground_truth_is_zero_residual(self):
        gt, data, rel = simulate()
        r = IF.residuals(gt, data, rel, gt, CFG)
        assert float(jnp.max(jnp.abs(r))) < 2e-2  # f32 integration noise only

    def test_recovers_velocity_and_bias(self):
        bg = [0.01, -0.02, 0.015]
        ba = [0.10, -0.05, 0.20]
        # 1 s intervals: long enough for the bias signal to clear the f32
        # integration noise floor (0.2 s intervals leave it unobservable)
        gt, data, rel = simulate(n_states=8, m=50, h=0.02, seed=3, bg=bg, ba=ba)
        # init: poses from (perfect) scan matching, zero velocity/bias
        x0 = gt._replace(
            v=jnp.zeros_like(gt.v),
            bg=jnp.zeros_like(gt.bg),
            ba=jnp.zeros_like(gt.ba),
        )
        prior = x0._replace(v=gt.v)  # anchor state0 velocity (odometry start)
        cfg = CFG._replace(
            prior_vel_sigma=0.01, odom_rot_sigma=1e-3, odom_trans_sigma=1e-3
        )
        x, chis = IF.solve_window(x0, data, rel, prior, cfg=cfg, gn_iters=10)
        assert float(chis[-1]) < float(chis[0]) * 1e-3
        np.testing.assert_allclose(np.asarray(x.v), np.asarray(gt.v), atol=0.01)
        np.testing.assert_allclose(
            np.asarray(x.bg[-1]), np.asarray(gt.bg[-1]), atol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(x.ba[-1]), np.asarray(gt.ba[-1]), atol=5e-3
        )

    def test_imu_corrects_noisy_odometry(self):
        """With IMU factors, noisy scan-matching poses get smoothed toward
        the (exact) inertial kinematics."""
        gt, data, rel = simulate(n_states=8, seed=5)
        rng = np.random.RandomState(11)
        noisy_p = np.asarray(gt.p) + rng.normal(0, 0.05, (8, 3))
        x0 = gt._replace(p=jnp.asarray(noisy_p, jnp.float32))
        prior = gt
        x, chis = IF.solve_window(x0, data, rel, prior, cfg=CFG, gn_iters=10)
        err0 = np.linalg.norm(noisy_p - np.asarray(gt.p), axis=1).mean()
        err1 = np.linalg.norm(np.asarray(x.p) - np.asarray(gt.p), axis=1).mean()
        assert err1 < err0 * 0.5, (err0, err1)


class TestImuSmoother:
    def test_window_interface(self):
        gt, data, rel = simulate(n_states=6, seed=7)
        sm = IF.ImuSmoother(window=6, max_samples=32, cfg=CFG)
        sm.states = gt._replace(
            v=jnp.zeros_like(gt.v), bg=jnp.zeros_like(gt.bg)
        )
        for i in range(5):
            sm.push_interval(
                np.asarray(data.accel[i]),
                np.asarray(data.gyro[i]),
                np.asarray(data.dt[i]),
                se3.Pose(rel.R[i], rel.t[i]),
            )
        x, chis = sm.solve(gn_iters=8)
        assert np.isfinite(float(chis[-1]))
        # velocities pulled from 0 toward the true kinematics
        np.testing.assert_allclose(
            np.asarray(x.v[1:]), np.asarray(gt.v[1:]), atol=0.1
        )

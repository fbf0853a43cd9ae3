"""IMU preintegration — batched.

The reference's LIO-SAM front end consumes IMU at high rate (full noise and
extrinsic parameters in ``config/dlc_lio_sam_params.yaml:39-70``). This
module provides the standard on-manifold preintegration (Forster et al.):
given accel/gyro samples between two LiDAR frames, produce the relative
(delta R, delta v, delta p) the interval implies — used here to seed the
scan-to-map ICP prediction (rotation especially, where constant-velocity
prediction is weakest), and usable as a between-factor measurement by
callers that track velocity states.

Everything is a ``lax.scan`` over samples; batching over intervals is a
``vmap`` away.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import so3


class ImuConfig(NamedTuple):
    gravity: float = 9.81
    accel_noise: float = 0.01      # m/s^2 /sqrt(Hz)  (ref imuAccNoise 3.99e-2)
    gyro_noise: float = 0.001      # rad/s /sqrt(Hz)  (ref imuGyrNoise 1.5e-3)
    accel_bias_noise: float = 6.4e-5   # ref imuAccBiasN
    gyro_bias_noise: float = 3.5e-5    # ref imuGyrBiasN
    # extrinsic rotation IMU->LiDAR (ref extrinsicRot); identity default
    R_lidar_imu: tuple = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


class PreintegratedImu(NamedTuple):
    delta_R: jax.Array     # [3, 3] rotation over the interval (body frame)
    delta_v: jax.Array     # [3] velocity change (gravity-free, body frame at t0)
    delta_p: jax.Array     # [3] position change (gravity-free, body frame at t0)
    dt_total: jax.Array    # scalar
    count: jax.Array       # number of samples integrated


def preintegrate(
    accel: jax.Array,      # [N, 3] specific force (body frame, includes -g)
    gyro: jax.Array,       # [N, 3] angular velocity (body frame)
    dt: jax.Array,         # [N] per-sample intervals (s); <=0 samples ignored
    gyro_bias: jax.Array | None = None,
    accel_bias: jax.Array | None = None,
    cfg: ImuConfig = ImuConfig(),
) -> PreintegratedImu:
    """Midpoint-free forward preintegration under lax.scan (f32-safe).

    Gravity is NOT removed here (delta_v/delta_p integrate the measured
    specific force); callers that need world-frame kinematics apply
    R_wb(t0) and add g*t terms — for ICP seeding only delta_R matters.
    """
    if gyro_bias is None:
        gyro_bias = jnp.zeros(3)
    if accel_bias is None:
        accel_bias = jnp.zeros(3)
    R_ext = jnp.asarray(cfg.R_lidar_imu).reshape(3, 3)

    def step(carry, inp):
        R, v, p, t = carry
        a, w, h = inp
        valid = h > 0
        h = jnp.maximum(h, 0.0)
        a = R_ext @ (a - accel_bias)
        w = R_ext @ (w - gyro_bias)
        dR = so3.exp(w * h)
        a_world = R @ a
        p2 = p + v * h + 0.5 * a_world * h * h
        v2 = v + a_world * h
        R2 = so3.orthonormalize(R @ dR)
        out = (
            jnp.where(valid, R2, R),
            jnp.where(valid, v2, v),
            jnp.where(valid, p2, p),
            t + h,
        )
        return out, valid

    init = (jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.zeros(()))
    (R, v, p, t), valids = jax.lax.scan(step, init, (accel, gyro, dt))
    return PreintegratedImu(
        delta_R=R, delta_v=v, delta_p=p, dt_total=t,
        count=jnp.sum(valids.astype(jnp.int32)),
    )


def gyro_delta_rotation(
    gyro: jax.Array, dt: jax.Array, gyro_bias: jax.Array | None = None,
    cfg: ImuConfig = ImuConfig(),
) -> jax.Array:
    """Rotation-only integration (the cheap prediction seed): [3, 3]."""
    pre = preintegrate(jnp.zeros_like(gyro), gyro, dt, gyro_bias, None, cfg)
    return pre.delta_R


def synthesize_between_frames(T0, T1, n_samples: int, rate_dt: float, g=9.81):
    """Test/simulation helper: constant-twist IMU samples realizing the

    relative motion T0 -> T1 over n_samples of spacing rate_dt. Returns
    (accel [N,3], gyro [N,3], dt [N]) in the body frame (specific force
    includes gravity reaction)."""
    import numpy as np

    from ..geometry import se3 as _se3

    T0 = np.asarray(T0)
    T1 = np.asarray(T1)
    total = n_samples * rate_dt
    rel = np.linalg.inv(T0) @ T1
    import jax.numpy as jnp_

    xi = np.asarray(
        _se3.log(_se3.Pose(jnp_.asarray(rel[:3, :3]), jnp_.asarray(rel[:3, 3])))
    )
    w = xi[:3] / total              # body angular velocity (constant)
    # body-frame velocity of the twist; for gyro seeding tests the exact
    # accel profile matters less than the rotation
    v_body = xi[3:] / total
    gyro = np.tile(w, (n_samples, 1))
    # specific force: rotate gravity into the (rotating) body frame + the
    # centripetal term from constant angular velocity acting on v_body
    acc = []
    R = T0[:3, :3].copy()
    g_world = np.array([0.0, 0.0, -g])
    for _ in range(n_samples):
        a_body = -(R.T @ g_world) + np.cross(w, v_body)
        acc.append(a_body)
        Rd = np.asarray(so3.exp(jnp_.asarray(w * rate_dt)))
        R = R @ Rd
    return (
        np.asarray(acc, np.float32),
        gyro.astype(np.float32),
        np.full(n_samples, rate_dt, np.float32),
    )

"""Scan deskewing (motion compensation) — pure batched device ops.

A spinning LiDAR's points are captured over the whole sweep (~100 ms)
while the sensor moves; feeding the raw packet to registration smears
every surface along the trajectory. Every reference front end deskews
(FAST-LIO2 back-propagates each point through the IMU-propagated pose to
the scan-end time; the reference selects those front ends in
``launch/single_ugv.launch:33-39``). The device form is one fused
elementwise pass — no per-point host loop, no sorting:

- :func:`azimuth_sweep_times` recovers per-point sweep fractions from
  azimuth when the packet carries no timestamps (the KITTI situation).
- :func:`deskew_constant_twist` moves every point into the common
  sweep-end frame under a constant-twist motion model: with the sweep
  motion ``M`` (pose at sweep end expressed in the sweep-start frame) and
  ``xi = log(M)``, the sensor frame at fraction ``tau`` relates to the
  end frame by ``exp((tau - 1) xi)`` (same-axis exponentials commute), so
  the correction is a per-point batched SE(3) exp — a handful of
  flops per point, fully fused by XLA.
- :func:`gyro_rotation_samples` + :func:`deskew_gyro` replace the
  constant-twist ROTATION with the gyro-integrated rotation trajectory
  (piecewise per IMU sample — at 100+ Hz IMU vs a 10 Hz sweep the
  within-sample rotation is <1% of the sweep's), keeping the
  constant-velocity translation. This is the FAST-LIO-style
  back-propagation: rotation is where constant-twist is weakest (fast
  yaw), and the gyro measures it directly.

Convention: times are sweep fractions in [0, 1]; the output is expressed
in the sensor frame AT SWEEP END, matching the convention that a frame's
odometry pose timestamps the end of its sweep.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import se3, so3
from . import pointcloud as pc


def azimuth_sweep_times(
    xyz: jax.Array, mask: jax.Array, clockwise: bool = False
) -> jax.Array:
    """Per-point sweep fraction tau in [0, 1] from azimuth angle.

    For sensors whose packets carry no per-point timestamps: one
    revolution per sweep, starting at azimuth -pi (atan2 branch cut), so
    ``tau = (atan2(y, x) + pi) / 2pi`` for a counter-clockwise spin (the
    simulator's azimuth ordering); ``clockwise=True`` flips it. Masked
    points get tau = 1 (identity correction on the pad sentinel).
    """
    az = jnp.arctan2(xyz[..., 1], xyz[..., 0])
    tau = (az + jnp.pi) / (2.0 * jnp.pi)
    if clockwise:
        tau = 1.0 - tau
    return jnp.where(mask, tau, 1.0)


def deskew_constant_twist(
    xyz: jax.Array,       # [N, 3] sensor-frame points as measured
    mask: jax.Array,      # [N]
    times: jax.Array,     # [N] sweep fractions in [0, 1]
    motion: se3.Pose,     # sweep motion: pose at tau=1 in the tau=0 frame
) -> jax.Array:
    """Move every point into the sweep-end sensor frame (constant twist).

    ``p_end = exp((tau - 1) xi) p`` with ``xi = log(motion)``. Exact for
    constant-twist motion; the correction at tau=1 is the identity, so an
    already-deskewed scan passes through unchanged.
    """
    xi = se3.log(motion)                               # [6]
    corr = se3.exp((times[:, None] - 1.0) * xi[None, :])   # batched [N]
    out = jnp.einsum("nij,nj->ni", corr.R, xyz) + corr.t
    return jnp.where(mask[:, None], out, pc.PAD_VALUE)


def gyro_rotation_samples(
    gyro: jax.Array,                  # [M, 3] body rates over the sweep
    dt: jax.Array,                    # [M] per-sample intervals (s), <=0 pad
    gyro_bias: jax.Array | None = None,
):
    """Cumulative gyro-integrated rotations at each sample boundary.

    Returns ``(R [M, 3, 3], tfrac [M])``: ``R[k]`` rotates the sensor
    frame at sample boundary k+1 into the sweep-start frame, ``tfrac[k]``
    is the cumulative time at that boundary as a fraction of the total
    (valid-sample) duration. Padded samples (dt <= 0) hold the previous
    value, so trailing pads are safe.
    """
    if gyro_bias is None:
        gyro_bias = jnp.zeros(3, gyro.dtype)

    def step(carry, inp):
        R, t = carry
        w, h = inp
        valid = h > 0
        h = jnp.maximum(h, 0.0)
        R2 = so3.orthonormalize(R @ so3.exp((w - gyro_bias) * h))
        R2 = jnp.where(valid, R2, R)
        t2 = t + h
        return (R2, t2), (R2, t2)

    (_, total), (Rs, ts) = jax.lax.scan(
        step, (jnp.eye(3, dtype=gyro.dtype), jnp.zeros((), gyro.dtype)),
        (gyro, dt),
    )
    tfrac = ts / jnp.maximum(total, 1e-9)
    return Rs, tfrac


def deskew_gyro(
    xyz: jax.Array,       # [N, 3] sensor-frame points as measured
    mask: jax.Array,      # [N]
    times: jax.Array,     # [N] sweep fractions in [0, 1]
    sample_R: jax.Array,  # [M, 3, 3] from gyro_rotation_samples
    sample_tfrac: jax.Array,  # [M]
    translation: jax.Array,   # [3] sweep translation in the start frame
) -> jax.Array:
    """Gyro-rotation + constant-velocity-translation deskew to sweep end.

    The relative motion since sweep start is ``D(tau) = (R(tau),
    tau * translation)`` with R(tau) the gyro-integrated rotation
    (piecewise per sample); each point moves by ``D(1)^{-1} D(tau)``.
    """
    # piecewise rotation: the last sample boundary at or before tau;
    # points BEFORE the first boundary get the identity (sweep-start
    # frame), not the first interval's end rotation (code-review r5:
    # the clip-to-0 form displaced early-sweep points by one sample's
    # rotation)
    raw = jnp.searchsorted(sample_tfrac, times, side="right") - 1
    idx = jnp.clip(raw, 0, sample_R.shape[0] - 1)
    # a plain [N, 3, 3] row gather is cheap next to registration's
    # NN pass; no need for anything fancier
    R_tau = jnp.where(
        (raw < 0)[:, None, None],
        jnp.eye(3, dtype=sample_R.dtype),
        sample_R[idx],
    )                                                   # [N, 3, 3]
    R_end = sample_R[-1]
    t_end = translation
    # D(1)^{-1} D(tau) = (R_end^T R_tau, R_end^T (tau*t_end - t_end))
    Rc = jnp.einsum("ji,njk->nik", R_end, R_tau)        # R_end^T @ R_tau
    tc = jnp.einsum(
        "ji,nj->ni", R_end, (times[:, None] - 1.0) * t_end[None, :]
    )
    out = jnp.einsum("nij,nj->ni", Rc, xyz) + tc
    return jnp.where(mask[:, None], out, pc.PAD_VALUE)

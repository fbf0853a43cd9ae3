"""Batched SO(3) operations.

Rotation algebra used throughout the SLAM engine. All functions are
shape-polymorphic over leading batch dimensions and written for f32 device
execution (small-angle branches use Taylor guards rather than data-dependent
control flow so everything stays jittable/vmappable).

Capability parity: the reference stores rotations as GTSAM ``Rot3`` and PCL
roll/pitch/yaw triples (reference ``include/distributedMapping.h:214-231``);
here rotations are 3x3 matrices with exp/log maps for manifold optimization.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def orthonormalize(R: jax.Array, iters: int = 2) -> jax.Array:
    """Project a near-rotation back onto SO(3) (Newton-Schulz polar iteration).

    Chained f32 compositions drift off the manifold (observed |RR^T - I| ~
    1e-4 after ~60 composes), which makes trace-based angle extraction report
    phantom rotations and blows up log(). Two iterations of
    R <- R (3I - R^T R)/2 restore orthogonality to ~1e-8 for such inputs;
    cheap (2 matmuls/iter), batched, differentiable.
    """
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    for _ in range(iters):
        R = R @ (1.5 * eye3 - 0.5 * (jnp.swapaxes(R, -1, -2) @ R))
    return R


def exp(w: jax.Array) -> jax.Array:
    """Rodrigues' formula: axis-angle [..., 3] -> rotation matrix [..., 3, 3].

    Uses Taylor expansions of sin(t)/t and (1-cos t)/t^2 near t=0 so the
    function is smooth and finite everywhere (no NaN gradients at identity).
    """
    theta2 = jnp.sum(w * w, axis=-1)
    # Wide series branch (theta < 0.5): the closed forms hide catastrophic
    # f32 cancellations — worse, their DERIVATIVES contain 1/theta^4-scale
    # terms that cancel only analytically, so autodiffed Jacobians explode
    # (observed 5e7-scale entries at theta ~ 0.01). The truncated series are
    # f32-exact on this range and smooth. Also double-where: divisors must be
    # benign in the unselected branch or the chain rule drags NaN through.
    small = theta2 < 0.25
    safe_theta2 = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(safe_theta2)
    a = jnp.where(
        small,
        1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
        jnp.sin(theta) / theta,
    )
    b = jnp.where(
        small,
        0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
        (1.0 - jnp.cos(theta)) / safe_theta2,
    )
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def log(R: jax.Array) -> jax.Array:
    """Matrix log: rotation [..., 3, 3] -> axis-angle [..., 3].

    Stable near identity and near pi (falls back to the diagonal-based
    extraction in the near-pi region).
    """
    # guard against off-manifold input (see orthonormalize): a contracted
    # matrix yields trace-angle > 0 with antisymmetric part ~ 0, and the
    # theta/|u| scale below would explode
    R = orthonormalize(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # u = vee(R - R^T) = 2 sin(theta) * axis. Using |u| for the axis norm
    # (instead of sin(arccos(...))) keeps the result well-conditioned in f32
    # across the whole mid-range.
    u = vee(R - jnp.swapaxes(R, -1, -2))
    u2 = jnp.sum(u * u, axis=-1)  # = 4 sin^2(theta)
    # Thresholds must be far above f32 eps (~1.2e-7 near 1.0): 1.0 - 1e-8
    # would round to exactly 1.0 and the guard would never trigger.
    small = cos_t > 1.0 - 1e-6      # theta < ~1.4e-3
    near_pi = cos_t < -1.0 + 1e-6   # theta > pi - ~1.4e-3
    # Gradient safety: arccos has infinite slope at +-1 and jnp.where
    # propagates NaN through unselected branches, so feed arccos a benign
    # value wherever a series/diagonal branch is selected instead.
    safe_cos = jnp.where(small | near_pi, 0.0, cos_t)
    theta = jnp.arccos(safe_cos)
    # near 0: w ~ 0.5 * u * (1 + theta^2/6), with theta^2 ~ u2/4 (smooth in R)
    scale_small = 0.5 * (1.0 + u2 / 24.0)
    safe_u2 = jnp.where(small | near_pi, 1.0, u2)
    scale_mid = theta / jnp.sqrt(safe_u2)
    scale = jnp.where(small, scale_small, scale_mid)
    w_generic = scale[..., None] * u
    # theta for the near-pi branch (clipped away from the arccos singularity;
    # exact-pi gradients are clamped but finite)
    theta_pi = jnp.arccos(jnp.clip(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))

    # near-pi branch: w = theta * axis, axis from largest diagonal element
    # B = (R + I)/2 ; axis_i proportional to sqrt(B_ii), signs from off-diag.
    B = (R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)) * 0.5
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    axis_abs = jnp.sqrt(jnp.clip(diag, 0.0, None))
    k = jnp.argmax(diag, axis=-1)
    # sign fix: for chosen k, sign of axis_j = sign(B[k, j])
    Bk = jnp.take_along_axis(
        B, k[..., None, None].repeat(3, axis=-1), axis=-2
    )[..., 0, :]
    signs = jnp.where(Bk < 0, -1.0, 1.0)
    sign_k = jnp.take_along_axis(signs, k[..., None], axis=-1)  # [..., 1]
    axis = axis_abs * signs * sign_k  # make axis[k] positive overall sign
    norm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / jnp.maximum(norm, _EPS)
    w_pi = theta_pi[..., None] * axis

    return jnp.where(near_pi[..., None], w_pi, w_generic)


def left_jacobian(w: jax.Array) -> jax.Array:
    """SO(3) left Jacobian J_l(w): [..., 3] -> [..., 3, 3]."""
    theta2 = jnp.sum(w * w, axis=-1)
    # wide series branch: see exp() — f32 cancellation in values AND
    # autodiff tangents makes the closed forms unusable below theta ~ 0.5
    small = theta2 < 0.25
    safe_theta2 = jnp.where(small, 1.0, theta2)  # double-where NaN-grad guard
    theta = jnp.sqrt(safe_theta2)
    b = jnp.where(
        small,
        0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
        (1.0 - jnp.cos(theta)) / safe_theta2,
    )
    c = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
        (theta - jnp.sin(theta)) / (safe_theta2 * theta),
    )
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def left_jacobian_inv(w: jax.Array) -> jax.Array:
    """Inverse SO(3) left Jacobian: [..., 3] -> [..., 3, 3]."""
    theta2 = jnp.sum(w * w, axis=-1)
    # wide series branch: the closed cot form is a difference of two
    # ~1/theta^2 terms whose 1/theta^4-scale derivatives cancel only
    # analytically — in f32 this poisoned GN Jacobians with 5e7 entries at
    # theta ~ 0.01. Series error at theta = 0.5 is ~1e-7.
    small = theta2 < 0.25
    safe_theta2 = jnp.where(small, 1.0, theta2)  # double-where NaN-grad guard
    theta = jnp.sqrt(safe_theta2)
    sin_t = jnp.sin(theta)
    # sign-preserving guard: sin(theta) is negative for theta > pi
    safe_sin = jnp.where(jnp.abs(sin_t) < _EPS, _EPS, sin_t)
    # cot coefficient: 1/t^2 - (1 + cos t)/(2 t sin t)
    # series: 1/12 + t^2/720 + t^4/30240
    cot_coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 / safe_theta2) - (1.0 + jnp.cos(theta)) / (2.0 * theta * safe_sin),
    )
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot_coef[..., None, None] * W2


def from_euler(rpy: jax.Array) -> jax.Array:
    """Roll-pitch-yaw (x-y-z intrinsic, PCL/ROS convention) -> matrix.

    Matches ``pcl::getTransformation`` semantics used by the reference
    (``include/distributedMapping.h:221-224``): R = Rz(yaw) Ry(pitch) Rx(roll).
    """
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    row0 = jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = jnp.stack([-sp, cp * sr, cp * cr], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def to_euler(R: jax.Array) -> jax.Array:
    """Matrix -> roll-pitch-yaw (inverse of :func:`from_euler`)."""
    sp = -R[..., 2, 0]
    sp = jnp.clip(sp, -1.0, 1.0)
    pitch = jnp.arcsin(sp)
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1
    )
    row1 = jnp.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1
    )
    row2 = jnp.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1
    )
    return jnp.stack([row0, row1, row2], axis=-2)


def matrix_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z).

    Branch-free Shepperd's method: compute all four candidate quaternions and
    select the one keyed to the largest of (trace, R00, R11, R22).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate extractions, keyed on which diagonal term dominates
    s0 = jnp.sqrt(jnp.clip(1.0 + tr, _EPS, None)) * 2.0
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], axis=-1)
    s1 = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, _EPS, None)) * 2.0
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], axis=-1)
    s2 = jnp.sqrt(jnp.clip(1.0 - m00 + m11 - m22, _EPS, None)) * 2.0
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], axis=-1)
    s3 = jnp.sqrt(jnp.clip(1.0 - m00 - m11 + m22, _EPS, None)) * 2.0
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], axis=-1)

    cases = jnp.stack([q0, q1, q2, q3], axis=-2)  # [..., 4, 4]
    keys = jnp.stack([tr, m00, m11, m22], axis=-1)
    idx = jnp.argmax(keys, axis=-1)
    q = jnp.take_along_axis(cases, idx[..., None, None].repeat(4, axis=-1), axis=-2)[
        ..., 0, :
    ]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)

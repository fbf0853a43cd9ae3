"""Full 15-state IMU factors: pose + velocity + bias window smoothing.

The reference delegates IMU fusion to its LIO-SAM front end (GTSAM
``CombinedImuFactor`` over pose/velocity/bias states, configured by
``config/dlc_lio_sam_params.yaml:39-70``); the distributed mapper itself is
pose-only. This module is the JAX equivalent: on-manifold
preintegration factors (Forster et al., TRO 2017) over a sliding window of
15-dof states

    x_k = (R_k, p_k, v_k, b^g_k, b^a_k)

with scan-matching relative-pose factors tying the window to the LiDAR
odometry, a prior on the first state, and a bias random walk.

Design decisions:

- **Exact bias sensitivity by autodiff, not first-order correction.** GTSAM
  caches ∂Δ/∂b Jacobians and applies a first-order bias update to the
  preintegrated measurement. Here each GN iteration *re-preintegrates* at
  the current bias estimate inside the residual (``runtime/imu.py``'s
  ``lax.scan`` integrator is cheap and jit-fused), and ``jax.jacfwd``
  through the scan yields the exact Jacobian — no approximation, no cached
  Jacobian bookkeeping.
- **One dense Gauss-Newton.** A window of N states is 15N variables
  (N≤32 → ≤480): a single dense J^T W J + Cholesky solve is one small
  matmul chain, far below the threshold where sparse structure pays.
- Everything is fixed-shape: intervals carry a static max sample count with
  dt<=0 padding, so window sliding never recompiles.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3, so3
from ..runtime import imu as imu_mod


class ImuStates(NamedTuple):
    """Batched window states [N]."""

    R: jax.Array    # [N, 3, 3]
    p: jax.Array    # [N, 3]
    v: jax.Array    # [N, 3]
    bg: jax.Array   # [N, 3] gyro bias
    ba: jax.Array   # [N, 3] accel bias


class ImuWindowData(NamedTuple):
    """Raw IMU samples per interval (between consecutive states), padded to a
    static max sample count M (pad with dt=0 — ignored by the integrator)."""

    accel: jax.Array  # [N-1, M, 3] specific force (body frame)
    gyro: jax.Array   # [N-1, M, 3]
    dt: jax.Array     # [N-1, M]


class ImuFactorConfig(NamedTuple):
    gravity: float = 9.81
    # per-sqrt-second noise densities (reference dlc_lio_sam_params.yaml:40-43)
    gyro_noise: float = 1.5e-3
    accel_noise: float = 4e-2
    gyro_walk: float = 3.5e-5
    accel_walk: float = 6.4e-5
    # scan-matching relative pose factor sigmas (rot, trans)
    odom_rot_sigma: float = 1e-2
    odom_trans_sigma: float = 1e-1
    # first-state prior sigmas
    prior_rot_sigma: float = 1e-3
    prior_trans_sigma: float = 1e-3
    prior_vel_sigma: float = 1.0
    prior_bias_sigma: float = 0.1
    # sigma floor, expressed as a max information weight (1/sigma). The bias
    # random-walk sigmas (~3.5e-5) put raw weights at ~6e4; with them the
    # f32 linear solve loses the bias common-mode direction entirely (GN
    # recovers ~5%/iter — measured). Capping at 1e4 bounds cond(J) within
    # f32 and costs nothing statistically: one window cannot resolve a bias
    # below 1e-4 anyway.
    weight_cap: float = 1e4


def make_states(n: int) -> ImuStates:
    return ImuStates(
        R=jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (n, 1, 1)),
        p=jnp.zeros((n, 3), jnp.float32),
        v=jnp.zeros((n, 3), jnp.float32),
        bg=jnp.zeros((n, 3), jnp.float32),
        ba=jnp.zeros((n, 3), jnp.float32),
    )


def retract(x: ImuStates, delta: jax.Array) -> ImuStates:
    """x ⊕ δ with δ [N, 15] = (dθ, dp, dv, dbg, dba)."""
    return ImuStates(
        R=so3.orthonormalize(x.R @ jax.vmap(so3.exp)(delta[:, 0:3])),
        p=x.p + delta[:, 3:6],
        v=x.v + delta[:, 6:9],
        bg=x.bg + delta[:, 9:12],
        ba=x.ba + delta[:, 12:15],
    )


def _interval_residual(
    Ri, pi, vi, bgi, bai, Rj, pj, vj, accel, gyro, dt, cfg: ImuFactorConfig
):
    """9-vector (r_ΔR, r_Δv, r_Δp), Forster et al. eq. (45), with the
    preintegration evaluated AT the current bias estimate of state i."""
    pre = imu_mod.preintegrate(accel, gyro, dt, gyro_bias=bgi, accel_bias=bai)
    g = jnp.array([0.0, 0.0, -cfg.gravity])
    T = pre.dt_total
    r_R = so3.log(pre.delta_R.T @ (Ri.T @ Rj))
    r_v = Ri.T @ (vj - vi - g * T) - pre.delta_v
    r_p = Ri.T @ (pj - pi - vi * T - 0.5 * g * T * T) - pre.delta_p
    return jnp.concatenate([r_R, r_v, r_p]), T


def residuals(
    x: ImuStates,
    data: ImuWindowData,
    odom_rel: se3.Pose,       # [N-1] scan-matching relative poses i->i+1
    prior: ImuStates,         # first-state prior (index 0 read)
    cfg: ImuFactorConfig,
) -> jax.Array:
    """Weighted residual vector for the whole window (fixed shape)."""
    n = x.p.shape[0]
    Ri, pi, vi = x.R[:-1], x.p[:-1], x.v[:-1]
    Rj, pj, vj = x.R[1:], x.p[1:], x.v[1:]

    r_imu, T = jax.vmap(_interval_residual, in_axes=(0,) * 11 + (None,))(
        Ri, pi, vi, x.bg[:-1], x.ba[:-1], Rj, pj, vj,
        data.accel, data.gyro, data.dt, cfg,
    )
    # diagonal covariance approximation of the propagated preintegration
    # noise: rot/vel σ grow as √T, position as T^1.5 (double integration)
    Tc = jnp.maximum(T, 1e-6)[:, None]
    sT = jnp.sqrt(Tc)
    w_imu = jnp.concatenate(
        [
            jnp.tile(1.0 / cfg.gyro_noise, (n - 1, 3)) / sT,
            jnp.tile(1.0 / cfg.accel_noise, (n - 1, 3)) / sT,
            jnp.tile(1.0 / cfg.accel_noise, (n - 1, 3)) / (sT * Tc),
        ],
        axis=1,
    )

    # bias random walk between consecutive states
    r_walk = jnp.concatenate([x.bg[1:] - x.bg[:-1], x.ba[1:] - x.ba[:-1]], axis=1)
    w_walk = jnp.concatenate(
        [
            jnp.tile(1.0 / cfg.gyro_walk, (n - 1, 3)) / sT,
            jnp.tile(1.0 / cfg.accel_walk, (n - 1, 3)) / sT,
        ],
        axis=1,
    )

    # scan-matching relative-pose factors
    pred = se3.between(se3.Pose(Ri, pi), se3.Pose(Rj, pj))
    r_odom = jax.vmap(lambda a, b: se3.log(se3.compose(se3.inverse(a), b)))(
        odom_rel, pred
    )
    w_odom = jnp.tile(
        jnp.array([1.0 / cfg.odom_rot_sigma] * 3 + [1.0 / cfg.odom_trans_sigma] * 3),
        (n - 1, 1),
    )

    # first-state prior (pose + velocity + bias)
    r_prior = jnp.concatenate(
        [
            so3.log(prior.R[0].T @ x.R[0]),
            x.p[0] - prior.p[0],
            x.v[0] - prior.v[0],
            x.bg[0] - prior.bg[0],
            x.ba[0] - prior.ba[0],
        ]
    )
    w_prior = jnp.concatenate(
        [
            jnp.full(3, 1.0 / cfg.prior_rot_sigma),
            jnp.full(3, 1.0 / cfg.prior_trans_sigma),
            jnp.full(3, 1.0 / cfg.prior_vel_sigma),
            jnp.full(6, 1.0 / cfg.prior_bias_sigma),
        ]
    )

    cap = cfg.weight_cap
    return jnp.concatenate(
        [
            (r_imu * jnp.minimum(w_imu, cap)).reshape(-1),
            (r_walk * jnp.minimum(w_walk, cap)).reshape(-1),
            (r_odom * jnp.minimum(w_odom, cap)).reshape(-1),
            r_prior * jnp.minimum(w_prior, cap),
        ]
    )


@functools.partial(jax.jit, static_argnames=("cfg", "gn_iters"))
def solve_window(
    x0: ImuStates,
    data: ImuWindowData,
    odom_rel: se3.Pose,
    prior: ImuStates,
    cfg: ImuFactorConfig = ImuFactorConfig(),
    gn_iters: int = 8,
    damping: float = 1e-6,
):
    """Dense Gauss-Newton over the window. Returns (states, chi2_history)."""
    n = x0.p.shape[0]

    def gn_step(x, _):
        def r_of(delta):
            return residuals(retract(x, delta.reshape(n, 15)), data, odom_rel, prior, cfg)

        zero = jnp.zeros(n * 15)
        r = r_of(zero)
        J = jax.jacfwd(r_of)(zero)
        H = J.T @ J
        # Jacobi equilibration: the weight spread (bias walk ~1/3.5e-5 vs
        # velocity priors ~1) puts the raw normal equations at condition
        # ~1e12 — beyond f32 Cholesky. Scaling to unit diagonal recovers it.
        d = jnp.sqrt(jnp.maximum(jnp.diag(H), 1e-12))
        Hs = H / (d[:, None] * d[None, :])
        Hs = Hs + damping * jnp.eye(n * 15)
        b = (-J.T @ r) / d
        L = jnp.linalg.cholesky(Hs)
        y = jax.scipy.linalg.cho_solve((L, True), b)
        # one step of iterative refinement: the weight spread leaves the
        # equilibrated system near the f32 precision edge, and the raw solve
        # systematically undershoots the bias directions (geometric creep at
        # ~0.7/iter without this)
        y = y + jax.scipy.linalg.cho_solve((L, True), b - Hs @ y)
        delta = y / d
        x2 = retract(x, delta.reshape(n, 15))
        # accept only if chi2 improves (guard against a bad damped step)
        r2 = residuals(x2, data, odom_rel, prior, cfg)
        better = jnp.sum(r2 * r2) < jnp.sum(r * r)
        x_next = jax.tree_util.tree_map(
            lambda a, bnew: jnp.where(better, bnew, a), x, x2
        )
        return x_next, jnp.sum(r * r)

    x, chis = jax.lax.scan(gn_step, x0, None, length=gn_iters)
    return x, chis


class ImuSmoother:
    """Sliding-window pose/velocity/bias smoother over keyframe intervals.

    Host-side shell: feed it per-interval raw IMU samples plus the
    scan-matching relative pose; it maintains the window, solves, and
    exposes the current velocity/bias estimates (the gravity-consistent
    prediction seed for the next scan registration)."""

    def __init__(
        self,
        window: int = 8,
        max_samples: int = 64,
        cfg: ImuFactorConfig = ImuFactorConfig(),
    ):
        import numpy as np

        self.window = window
        self.max_samples = max_samples
        self.cfg = cfg
        self._np = np
        self._accel: list = []
        self._gyro: list = []
        self._dt: list = []
        self._rel: list = []
        self.states = make_states(window)
        self._n = 1  # states currently constrained (first is the anchor)

    def push_interval(self, accel, gyro, dt, rel_pose: se3.Pose) -> None:
        """One keyframe interval: raw samples + scan-matching relative pose."""
        np = self._np
        M = self.max_samples
        a = np.zeros((M, 3), np.float32)
        g = np.zeros((M, 3), np.float32)
        h = np.zeros((M,), np.float32)
        k = min(len(dt), M)
        a[:k] = np.asarray(accel)[:k]
        g[:k] = np.asarray(gyro)[:k]
        h[:k] = np.asarray(dt)[:k]
        self._accel.append(a)
        self._gyro.append(g)
        self._dt.append(h)
        self._rel.append(rel_pose)
        if len(self._accel) > self.window - 1:
            self._accel.pop(0)
            self._gyro.pop(0)
            self._dt.pop(0)
            self._rel.pop(0)
            # slide the state window with the data: node k takes node k+1's
            # estimate; the vacated last node starts from the previous last
            # (fixed-lag marginalization-by-prior — node 0's prior re-anchors
            # at its post-slide estimate)
            self.states = jax.tree_util.tree_map(
                lambda a: jnp.concatenate([a[1:], a[-1:]], axis=0), self.states
            )
        self._n = min(self._n + 1, self.window)

    @property
    def node_count(self) -> int:
        """States currently constrained (1 anchor + pushed intervals)."""
        return self._n

    def set_node_pose(self, k: int, R, p) -> None:
        """Write a pose estimate (e.g. from scan matching) into node ``k``."""
        import jax.numpy as _jnp

        self.states = self.states._replace(
            R=self.states.R.at[k].set(_jnp.asarray(R, _jnp.float32)),
            p=self.states.p.at[k].set(_jnp.asarray(p, _jnp.float32)),
        )

    def set_node_velocity(self, k: int, v) -> None:
        """Seed a node's world-frame velocity (e.g. pose finite difference).

        Critical at startup: the solver linearizes around the current
        states, and a node at v=0 on a fast trajectory puts the accel
        residuals far outside the GN basin (measured: 10 m pose blow-ups
        at 20 m/s without seeding)."""
        import jax.numpy as _jnp

        self.states = self.states._replace(
            v=self.states.v.at[k].set(_jnp.asarray(v, _jnp.float32))
        )

    def solve(self, init: ImuStates | None = None, gn_iters: int = 8):
        """Solve the current window; returns (states, chi2_history).

        Intervals not yet filled are padded with zero-dt samples and
        identity relative poses — their residuals vanish, so the padded
        states ride along unconstrained-but-anchored (prior + walk)."""
        np = self._np
        W, M = self.window, self.max_samples
        k = len(self._accel)
        accel = np.zeros((W - 1, M, 3), np.float32)
        gyro = np.zeros((W - 1, M, 3), np.float32)
        dt = np.zeros((W - 1, M), np.float32)
        if k:
            accel[:k] = np.stack(self._accel)
            gyro[:k] = np.stack(self._gyro)
            dt[:k] = np.stack(self._dt)
        relR = np.tile(np.eye(3, dtype=np.float32), (W - 1, 1, 1))
        relt = np.zeros((W - 1, 3), np.float32)
        for i, z in enumerate(self._rel):
            relR[i] = np.asarray(z.R)
            relt[i] = np.asarray(z.t)
        data = ImuWindowData(jnp.asarray(accel), jnp.asarray(gyro), jnp.asarray(dt))
        rel = se3.Pose(jnp.asarray(relR), jnp.asarray(relt))
        x0 = self.states if init is None else init
        prior = jax.tree_util.tree_map(lambda a: a, x0)
        self.states, chis = solve_window(
            x0, data, rel, prior, cfg=self.cfg, gn_iters=gn_iters
        )
        return self.states, chis

"""Fixed-capacity SE(3) factor graph.

JAX replacement for the reference's GTSAM graph assembly
(``NonlinearFactorGraph`` + ``BetweenFactor<Pose3>`` + ``PriorFactor<Pose3>``,
reference ``include/distributedMapping.h:681-706, 784-823``). Factors live in
pre-allocated arrays with a count scalar so graph growth never recompiles.

Noise models are diagonal 6-vector *information sqrt* weights (GTSAM's
``noiseModel::Diagonal::Variances`` analog, reference
``include/distributedMapping.h:516-517``): residuals are multiplied
elementwise by ``sqrt_info = 1/sigma`` before squaring. Twist ordering is
(omega, v) = (rx, ry, rz, tx, ty, tz).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3


# reference noise defaults (variances), distributedMapping.h:516-517:
#   odometry: [1e-6, 1e-6, 1e-6, 1e-4, 1e-4, 1e-4] (rot, trans)
#   prior:    [1e-2, 1e-2, pi^2, 1e8, 1e8, 1e8]
ODOM_SQRT_INFO = tuple(1.0 / (v ** 0.5) for v in (1e-6,) * 3 + (1e-4,) * 3)
PRIOR_SQRT_INFO = tuple(
    1.0 / (v ** 0.5) for v in (1e-2, 1e-2, float(jnp.pi) ** 2, 1e8, 1e8, 1e8)
)


class FactorGraph(NamedTuple):
    """Between-factors (i -> j) plus prior factors, fixed capacity."""

    # between factors
    i: jax.Array            # [E] int32
    j: jax.Array            # [E] int32
    z: se3.Pose             # [E] measured relative pose i->j
    sqrt_info: jax.Array    # [E, 6] diagonal sqrt information
    num_edges: jax.Array    # scalar int32

    # prior factors
    prior_idx: jax.Array    # [P] int32
    prior_z: se3.Pose       # [P]
    prior_sqrt_info: jax.Array  # [P, 6]
    num_priors: jax.Array   # scalar int32

    @property
    def edge_capacity(self) -> int:
        return self.i.shape[0]

    @property
    def prior_capacity(self) -> int:
        return self.prior_idx.shape[0]

    def edge_mask(self) -> jax.Array:
        return jnp.arange(self.edge_capacity) < self.num_edges

    def prior_mask(self) -> jax.Array:
        return jnp.arange(self.prior_capacity) < self.num_priors


def make_graph(edge_capacity: int, prior_capacity: int = 8) -> FactorGraph:
    return FactorGraph(
        i=jnp.zeros(edge_capacity, jnp.int32),
        j=jnp.zeros(edge_capacity, jnp.int32),
        z=se3.identity((edge_capacity,)),
        sqrt_info=jnp.zeros((edge_capacity, 6), jnp.float32),
        num_edges=jnp.zeros((), jnp.int32),
        prior_idx=jnp.zeros(prior_capacity, jnp.int32),
        prior_z=se3.identity((prior_capacity,)),
        prior_sqrt_info=jnp.zeros((prior_capacity, 6), jnp.float32),
        num_priors=jnp.zeros((), jnp.int32),
    )


def add_between(
    g: FactorGraph, i, j, z: se3.Pose, sqrt_info
) -> FactorGraph:
    """Functional append of a BetweenFactor (no-op when full)."""
    pos = jnp.minimum(g.num_edges, g.edge_capacity - 1)
    ok = g.num_edges < g.edge_capacity
    sqrt_info = jnp.asarray(sqrt_info, jnp.float32)
    return g._replace(
        i=g.i.at[pos].set(jnp.where(ok, i, g.i[pos])),
        j=g.j.at[pos].set(jnp.where(ok, j, g.j[pos])),
        z=se3.Pose(
            g.z.R.at[pos].set(jnp.where(ok, z.R, g.z.R[pos])),
            g.z.t.at[pos].set(jnp.where(ok, z.t, g.z.t[pos])),
        ),
        sqrt_info=g.sqrt_info.at[pos].set(
            jnp.where(ok, sqrt_info, g.sqrt_info[pos])
        ),
        num_edges=g.num_edges + ok.astype(jnp.int32),
    )


def add_between_block(
    g: FactorGraph, i, j, z: se3.Pose, sqrt_info
) -> FactorGraph:
    """Vectorized append of B between factors in one shot.

    Rows that would overflow capacity are dropped (the same
    no-op-when-full semantics as B sequential :func:`add_between` calls).
    i/j: [B] int; z: batched Pose; sqrt_info: [B, 6] or [6] (broadcast).
    """
    B = jnp.asarray(i).shape[0]
    E = g.edge_capacity
    sqrt_info = jnp.broadcast_to(
        jnp.asarray(sqrt_info, jnp.float32), (B, 6)
    )
    pos = g.num_edges + jnp.arange(B, dtype=jnp.int32)
    ok = pos < E
    pos_w = jnp.where(ok, pos, E)  # scratch row for dropped writes

    def scatter(arr, rows):
        pad = jnp.zeros((1,) + arr.shape[1:], arr.dtype)
        return jnp.concatenate([arr, pad])[: E + 1].at[pos_w].set(
            rows.astype(arr.dtype)
        )[:E]

    return g._replace(
        i=scatter(g.i, jnp.asarray(i, jnp.int32)),
        j=scatter(g.j, jnp.asarray(j, jnp.int32)),
        z=se3.Pose(scatter(g.z.R, z.R), scatter(g.z.t, z.t)),
        sqrt_info=scatter(g.sqrt_info, sqrt_info),
        num_edges=g.num_edges + jnp.sum(ok.astype(jnp.int32)),
    )


def add_prior(g: FactorGraph, idx, z: se3.Pose, sqrt_info) -> FactorGraph:
    pos = jnp.minimum(g.num_priors, g.prior_capacity - 1)
    ok = g.num_priors < g.prior_capacity
    sqrt_info = jnp.asarray(sqrt_info, jnp.float32)
    return g._replace(
        prior_idx=g.prior_idx.at[pos].set(jnp.where(ok, idx, g.prior_idx[pos])),
        prior_z=se3.Pose(
            g.prior_z.R.at[pos].set(jnp.where(ok, z.R, g.prior_z.R[pos])),
            g.prior_z.t.at[pos].set(jnp.where(ok, z.t, g.prior_z.t[pos])),
        ),
        prior_sqrt_info=g.prior_sqrt_info.at[pos].set(
            jnp.where(ok, sqrt_info, g.prior_sqrt_info[pos])
        ),
        num_priors=g.num_priors + ok.astype(jnp.int32),
    )


def between_residuals(g: FactorGraph, poses: se3.Pose) -> jax.Array:
    """Unweighted residuals r_e = log(z^-1 · (T_i^-1 T_j)) for all edge slots.

    [E, 6]; invalid slots produce garbage that callers mask.
    """
    Ti = se3.take(poses, g.i)
    Tj = se3.take(poses, g.j)
    pred = se3.between(Ti, Tj)
    return se3.log(se3.compose(se3.inverse(g.z), pred))


def prior_residuals(g: FactorGraph, poses: se3.Pose) -> jax.Array:
    """r_p = log(z^-1 · T_idx) for all prior slots. [P, 6]."""
    T = se3.take(poses, g.prior_idx)
    return se3.log(se3.compose(se3.inverse(g.prior_z), T))


def chi2(g: FactorGraph, poses: se3.Pose) -> jax.Array:
    """Total weighted squared error (masked)."""
    re = between_residuals(g, poses) * g.sqrt_info
    rp = prior_residuals(g, poses) * g.prior_sqrt_info
    re2 = jnp.sum(re * re, axis=-1) * g.edge_mask()
    rp2 = jnp.sum(rp * rp, axis=-1) * g.prior_mask()
    return jnp.sum(re2) + jnp.sum(rp2)

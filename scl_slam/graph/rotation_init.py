"""Chordal rotation averaging — the rotation stage of the two-stage solve.

The reference's ``distributedOptimizer`` runs a two-stage distributed
Gauss-Seidel: rotations first, then poses (``robust_distributed_mapper``,
reference ``include/distributedMapping.h:878-880``). The JAX
equivalent of the rotation stage is **chordal initialization** (Martinec &
Pajdla / Carlone et al.): treat the 9 entries of every R_i as free
variables, minimize

    sum_e || R_j - R_i Z_ij ||_F^2

— a sparse LINEAR least-squares solved matrix-free with CG (each column of R
independently), then project the solutions back onto SO(3). Converges
globally regardless of initial rotations (the failure mode GN alone has with
large loop-closure rotation errors), after which the GN pose solve
(:mod:`.solver` or the sharded variant) refines jointly.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3, so3
from . import factors as F


@partial(jax.jit, static_argnames=("cg_iters",))
def chordal_rotation_init(
    g: F.FactorGraph,
    poses: se3.Pose,
    anchor: jax.Array | int = 0,
    cg_iters: int = 128,
) -> se3.Pose:
    """Rotation-averaged poses: rotations from the chordal solve (anchored at

    ``anchor``'s current rotation), translations untouched."""
    n = poses.t.shape[0]
    emask = g.edge_mask().astype(poses.t.dtype)

    # Gauge anchoring, two tiers:
    #
    # 1. STRONG anchor (weight 10) at the graph's first prior, tied to the
    #    prior's MEASURED rotation — the bad initial rotations are exactly
    #    what chordal discards, so the absolute gauge must come from the
    #    measurement, not the estimate.
    # 2. WEAK ties (weight 0.1) at every other valid prior pose, to its
    #    CURRENT rotation. One anchor is not enough in multi-robot graphs:
    #    before the first inter-robot loop each peer's chain is a separate
    #    connected component whose chordal system is rank-deficient up to a
    #    global rotation — CG then drifts its rotations off the odometry
    #    estimate a little per drain, corrupting the mirrored peer poses
    #    that geometric verification map-frames against (measured: 3-robot
    #    cross-loop count dropped with a single anchor). The tie is weak so
    #    that once a component IS loop-connected, the (unit-weight, many)
    #    between factors dominate and the loop-found gauge wins.
    has_prior = g.num_priors > 0
    anchor = jnp.where(has_prior, g.prior_idx[0], anchor)
    anchor_R = jnp.where(has_prior, g.prior_z.R[0], poses.R[anchor])
    pmask = g.prior_mask().astype(poses.t.dtype)
    pweak = 0.1 * pmask.at[0].set(0.0)

    # normal equations for min sum_e w_e || X_j - X_i Z_e ||^2 over X in R^{n x 3 x 3}
    # A^T A X: for edge (i, j): contribution to i: (X_i Z - X_j) Z^T ; to j: (X_j - X_i Z)
    Z = g.z.R

    def apply_AtA(X):  # X: [n, 3, 3]
        Xi = X[g.i]
        Xj = X[g.j]
        XiZ = jnp.einsum("eab,ebc->eac", Xi, Z)
        r = XiZ - Xj                      # [E, 3, 3]
        r = r * emask[:, None, None]
        out = jnp.zeros_like(X)
        out = out.at[g.i].add(jnp.einsum("eac,ebc->eab", r, Z))
        out = out.at[g.j].add(-r)
        out = out.at[g.prior_idx].add(
            pweak[:, None, None] * X[g.prior_idx]
        )
        out = out.at[anchor].add(10.0 * X[anchor])
        return out

    b = jnp.zeros((n, 3, 3), poses.t.dtype)
    b = b.at[g.prior_idx].add(
        pweak[:, None, None] * poses.R[g.prior_idx]
    )
    b = b.at[anchor].add(10.0 * anchor_R)

    # CG on the (PSD) normal system
    X0 = poses.R

    def cg_step(state, _):
        X, r, p, rs = state
        Ap = apply_AtA(p)
        alpha = rs / jnp.maximum(jnp.sum(p * Ap), 1e-30)
        X2 = X + alpha * p
        r2 = r - alpha * Ap
        rs2 = jnp.sum(r2 * r2)
        p2 = r2 + (rs2 / jnp.maximum(rs, 1e-30)) * p
        return (X2, r2, p2, rs2), None

    r0 = b - apply_AtA(X0)
    (X, *_), _ = jax.lax.scan(
        cg_step, (X0, r0, r0, jnp.sum(r0 * r0)), None, length=cg_iters
    )

    # project each X_i onto SO(3) via SVD polar factor
    U, _, Vt = jnp.linalg.svd(X)
    det = jnp.linalg.det(jnp.einsum("nab,nbc->nac", U, Vt))
    D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    R = jnp.einsum("nab,nb,nbc->nac", U, D, Vt)
    return se3.Pose(R, poses.t)


def solve_two_stage(
    g: F.FactorGraph,
    poses: se3.Pose,
    gn_iters: int = 8,
    cg_iters: int = 64,
    **kw,
):
    """Rotation init then GN refine — the ``distributedOptimizer`` contract

    (rotation stage + pose stage) as one call."""
    from . import solver

    init = chordal_rotation_init(g, poses)
    return solver.solve(g, init, gn_iters=gn_iters, cg_iters=cg_iters, **kw)

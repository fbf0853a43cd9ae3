"""Manifold Gauss-Newton / Levenberg-Marquardt pose-graph solver.

JAX replacement for GTSAM iSAM2 (reference
``include/distributedMapping.h:520-523, 885-900``). The reference re-optimizes
in batch on every loop event anyway (via ``distributedOptimizer``), so a
damped batch GN with warm starts reproduces its behavior; "incremental"
updates fall out of warm-starting from the previous estimate.

Design (SURVEY §7.6): per-edge 6x6 Jacobian blocks via vmapped forward-mode
autodiff at the current linearization point; normal equations are never
materialized — the Gauss-Newton matrix is applied matrix-free with
gather/segment-sum (einsum-shaped), solved by preconditioned
conjugate gradients with an exact block-Jacobi (6x6 Cholesky) preconditioner.
Everything runs under ``lax.scan`` with static iteration counts: one jitted
``solve`` handles any graph up to capacity with zero recompiles.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from . import factors as F


class SolveResult(NamedTuple):
    poses: se3.Pose
    chi2_history: jax.Array   # [gn_iters + 1]
    cg_residuals: jax.Array   # [gn_iters] final CG residual norms
    delta_norms: jax.Array    # [gn_iters] update magnitudes


def _edge_residual(xi_i, xi_j, Ti_R, Ti_t, Tj_R, Tj_t, z_R, z_t):
    Ti = se3.retract(se3.Pose(Ti_R, Ti_t), xi_i)
    Tj = se3.retract(se3.Pose(Tj_R, Tj_t), xi_j)
    z = se3.Pose(z_R, z_t)
    return se3.log(se3.compose(se3.inverse(z), se3.between(Ti, Tj)))


def _prior_residual(xi, T_R, T_t, z_R, z_t):
    T = se3.retract(se3.Pose(T_R, T_t), xi)
    return se3.log(se3.compose(se3.inverse(se3.Pose(z_R, z_t)), T))


# vmapped per-edge Jacobians wrt the two pose perturbations, at xi = 0
_edge_jac = jax.vmap(
    jax.jacfwd(_edge_residual, argnums=(0, 1)),
    in_axes=(0, 0, 0, 0, 0, 0, 0, 0),
)
_prior_jac = jax.vmap(jax.jacfwd(_prior_residual, argnums=0))


def huber_weight(r_norm2: jax.Array, delta: float) -> jax.Array:
    """IRLS weight for the Huber kernel on the weighted residual norm."""
    r = jnp.sqrt(jnp.maximum(r_norm2, 1e-12))
    return jnp.where(r <= delta, 1.0, delta / r)


def _linearize(g: F.FactorGraph, poses: se3.Pose, huber_delta: float):
    """Residuals, Jacobian blocks, and IRLS x noise weights at ``poses``.

    Jacobian blocks are returned TRANSPOSED, as [6, 6, E] ("structure of
    arrays"): the edge axis minormost keeps each Jacobian array one dense
    [6, 6, E] block, where an [E, 6, 6] layout leaves the 36-float blocks
    as tiny minor dims that tiled device layouts pad many times over.
    """
    E = g.edge_capacity
    zeros6 = jnp.zeros((E, 6), poses.t.dtype)
    Ti = se3.take(poses, g.i)
    Tj = se3.take(poses, g.j)
    r_e = jax.vmap(_edge_residual)(
        zeros6, zeros6, Ti.R, Ti.t, Tj.R, Tj.t, g.z.R, g.z.t
    )
    Ji, Jj = _edge_jac(zeros6, zeros6, Ti.R, Ti.t, Tj.R, Tj.t, g.z.R, g.z.t)
    JiT = jnp.transpose(Ji, (1, 2, 0))            # [6, 6, E]
    JjT = jnp.transpose(Jj, (1, 2, 0))

    P = g.prior_capacity
    zerosP = jnp.zeros((P, 6), poses.t.dtype)
    Tp = se3.take(poses, g.prior_idx)
    r_p = jax.vmap(_prior_residual)(zerosP, Tp.R, Tp.t, g.prior_z.R, g.prior_z.t)
    JpT = jnp.transpose(
        _prior_jac(zerosP, Tp.R, Tp.t, g.prior_z.R, g.prior_z.t), (1, 2, 0)
    )

    # weights: diagonal information * robust kernel * validity mask
    info_e = g.sqrt_info ** 2                     # [E, 6]
    wr_e = r_e * g.sqrt_info
    rho_e = huber_weight(jnp.sum(wr_e * wr_e, -1), huber_delta)  # [E]
    w_e = info_e * (rho_e * g.edge_mask())[:, None]

    info_p = g.prior_sqrt_info ** 2
    w_p = info_p * g.prior_mask()[:, None]
    return r_e, JiT, JjT, w_e, r_p, JpT, w_p


def _apply_H(x, g, JiT, JjT, w_e, JpT, w_p, D_damp_only):
    """y = (J^T W J + damping) x, matrix-free. x, y: [N, 6].

    JiT/JjT/JpT are [6, 6, E] transposed blocks (see _linearize): the
    per-edge 6x6 matvecs become lane-vectorized contractions over the long
    E axis instead of batched tiny matmuls over pathologically-padded
    [E, 6, 6] arrays.
    """
    xi = x[g.i]
    xj = x[g.j]
    u = (
        jnp.einsum("abe,eb->ea", JiT, xi) + jnp.einsum("abe,eb->ea", JjT, xj)
    ) * w_e
    y = jnp.zeros_like(x)
    y = y.at[g.i].add(jnp.einsum("abe,ea->eb", JiT, u))
    y = y.at[g.j].add(jnp.einsum("abe,ea->eb", JjT, u))
    up = jnp.einsum("abp,pb->pa", JpT, x[g.prior_idx]) * w_p
    y = y.at[g.prior_idx].add(jnp.einsum("abp,pa->pb", JpT, up))
    # damping term (D_damp_only holds just the added diagonal part)
    y = y + jnp.einsum("nab,nb->na", D_damp_only, x)
    return y


def make_dense_coarse(
    cur_poses: se3.Pose,
    JiT, JjT, JpT,          # transposed Jacobian blocks [6, 6, E] / [6, 6, P]
    w_e, w_p,               # [E, 6] / [P, 6] weights (validity folded in)
    gi, gj, p_idx,          # endpoint indices of the LOCAL edge/prior arrays
    n_poses: int,
    stride_l: int,
    psum_axis: str | None = None,
):
    """Assemble + factor the dense Galerkin coarsest level; return its solve.

    The rigid-body+hat-transfer coarse space, flat-index assembly, f32
    equilibration, and shift ladder documented inline below. Shared by the
    single-device solver (``solve``) and the factor-sharded distributed
    solver (``parallel.sharded.sharded_solve``): under ``shard_map`` each
    device assembles its EDGE SHARD's contribution and ``psum_axis``
    reduces the dense matrix once — everything after the reduction is
    replicated math, so the returned ``coarse_apply`` is bit-identical
    across devices.

    Returns ``coarse_apply(v) -> [N, 6]``: one direct coarse solve of v
    restricted to the coarse space (P A_c^-1 P^T v), with one iterative
    refinement step; the zero map if the factorization never goes finite.
    """
    dtype = JiT.dtype
    C = (n_poses + stride_l - 1) // stride_l
    cidx = jnp.arange(n_poses) // stride_l
    # RIGID-BODY + hat transfer — the coarse space must
    # contain the operator's near-nullspace (the elasticity
    # AMG rule). Two measured failure modes shaped this:
    # (a) piecewise-CONSTANT transfer cannot represent any
    # smooth sloped error — a 4 m translation ramp at 32k
    # poses restricted to a 0.015 m coarse force (H·ramp is
    # zero in the chain interior), leaving the coarse grid
    # blind to exactly the long-range modes it exists for;
    # (b) hat-function transfer on raw (omega, v) dofs
    # represents translation ramps but not BENDING — a pose
    # chain's cheapest long-range motion is rotating early
    # poses and letting downstream translations swing
    # (energy w_rot·theta² vs w_trans·N·slope²), so the
    # H-optimal coarse approximation buys cheap bending-like
    # rot/trans combos and lands pointwise-wrong (measured:
    # the -4..0 step approximated as -1.3..+2.8).
    # Each coarse node therefore carries a WORLD rigid twist
    # (omega_c, v_c) about its cell centroid m_c; pose k
    # takes dx_k (BODY frame, right-multiplicative retract)
    #   omega_k = R_k^T omega_c
    #   v_k     = R_k^T (v_c + omega_c x (t_k - m_c))
    # hat-blended between its two nearest cell centers.
    # Translation ramps (omega=0, v varying) AND bending
    # (omega_c with lever arms) are then exactly
    # representable, so the Galerkin solve corrects both.
    #
    # The matrix is assembled FLAT by index arithmetic: a scatter
    # into [C,6,C,6] would tile-pad the minormost (C, 6) dims
    # 6->128 (12.9 GB at C=2048, the round-1 OOM); the flat
    # [C*6*C*6] target plus [*,36] block updates stays at the
    # unpadded 604 MB. C*6 must keep (C*6)^2 < 2^31 for the
    # int32 flat index — C <= 7723, i.e. use more levels
    # rather than a bigger dense coarse grid.
    n6 = C * 6
    assert n6 * n6 < 2**31, (
        "dense coarse level too big; raise coarse_stride or "
        "coarse_levels"
    )
    u = (jnp.arange(n_poses, dtype=dtype) + 0.5) / stride_l - 0.5
    cn0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, C - 1)
    cn1 = jnp.minimum(cn0 + 1, C - 1)
    wn1 = jnp.clip(u - cn0, 0.0, 1.0)
    wn0 = 1.0 - wn1

    # cell centroids of the current translations
    t_cur = cur_poses.t
    csum = jnp.zeros((C, 3), t_cur.dtype).at[cidx].add(t_cur)
    ccnt = jnp.zeros((C,), t_cur.dtype).at[cidx].add(1.0)
    m_c = csum / jnp.maximum(ccnt, 1.0)[:, None]

    def pblock(node, w):
        """[N, 6, 6] body-frame prolongation blocks P_k,node
        (weight folded in)."""
        r = t_cur - m_c[node]                    # lever [N,3]
        RT = jnp.swapaxes(cur_poses.R, -1, -2)
        zero = jnp.zeros_like(r[:, 0])
        skew_r = jnp.stack(
            [
                jnp.stack([zero, -r[:, 2], r[:, 1]], -1),
                jnp.stack([r[:, 2], zero, -r[:, 0]], -1),
                jnp.stack([-r[:, 1], r[:, 0], zero], -1),
            ],
            -2,
        )
        top = jnp.concatenate(
            [RT, jnp.zeros_like(RT)], axis=-1
        )                                         # [N,3,6]
        bot = jnp.concatenate(
            [-jnp.einsum("nab,nbc->nac", RT, skew_r), RT],
            axis=-1,
        )
        return (
            jnp.concatenate([top, bot], axis=-2)
            * w[:, None, None]
        )

    P0 = pblock(cn0, wn0)                        # [N,6,6]
    P1 = pblock(cn1, wn1)

    # per-edge/prior coarse Jacobians, transposed [6,6,E]
    def fold(JT, idx, Pb):
        return jnp.einsum("abe,ebc->ace", JT, Pb[idx])

    slots_e = [
        (cn0[gi], fold(JiT, gi, P0)),
        (cn1[gi], fold(JiT, gi, P1)),
        (cn0[gj], fold(JjT, gj, P0)),
        (cn1[gj], fold(JjT, gj, P1)),
    ]
    slots_p = [
        (cn0[p_idx], fold(JpT, p_idx, P0)),
        (cn1[p_idx], fold(JpT, p_idx, P1)),
    ]
    a6 = jnp.arange(6, dtype=jnp.int32)

    def rows(c):
        return c[:, None] * 6 + a6               # [*, 6]

    def flat_blk(r, c):
        return (r[:, :, None] * n6 + c[:, None, :]).reshape(
            -1, 36
        )

    # Chunked accumulation: with stride_l poses per supernode
    # a single flat scatter adds up to ~stride_l edge blocks
    # SERIALLY into each target — f32 error ~dups*eps wiped
    # out the small (long-range) eigenvalues at stride 4096
    # (observed: asym 4e1, min eig -2e-2 after equilibration
    # => Cholesky NaN). Spreading edges over K chunk copies
    # and tree-summing cuts the serial depth to ~stride_l/K.
    E_local = JiT.shape[2]
    K = 1
    while (
        K < 256
        and stride_l // K > 64
        and 2 * K * n6 * n6 * 4 <= (1 << 30)
    ):
        K *= 2
    chunk = (jnp.arange(E_local, dtype=jnp.int32) % K) * (n6 * n6)
    as36 = lambda B: B.reshape(B.shape[0], 36)
    Hc = jnp.zeros((K * n6 * n6,), dtype)
    ch = chunk[:, None]
    for na, Ka in slots_e:
        for nb, Kb in slots_e:
            blk = jnp.einsum("abe,ea,ace->ebc", Ka, w_e, Kb)
            Hc = Hc.at[flat_blk(rows(na), rows(nb)) + ch].add(
                as36(blk)
            )
    Hc = Hc.reshape(K, n6 * n6).sum(0)
    for na, Ka in slots_p:
        for nb, Kb in slots_p:
            blk = jnp.einsum("abp,pa,acp->pbc", Ka, w_p, Kb)
            Hc = Hc.at[
                flat_blk(rows(na), rows(nb)).reshape(-1)
            ].add(as36(blk).reshape(-1))
    Hc = Hc.reshape(n6, n6)
    if psum_axis is not None:
        # factor-sharded assembly: each device contributed its edge
        # shard (and, via the caller's w_p masking, exactly one copy of
        # the priors); ONE reduction makes the dense matrix global
        Hc = jax.lax.psum(Hc, psum_axis)
    Hc = 0.5 * (Hc + Hc.T)
    # Invertibility floor for EMPTY supernodes only: a
    # relative 1e-8 diagonal shift. Do NOT aggregate the
    # per-pose damp_blocks here — summed over stride^levels
    # poses they overwhelm the coarse grid's smallest
    # (smooth-mode) eigenvalues, silently zeroing the
    # long-range correction the dense level exists to
    # provide (measured: 0.02/pose damping aggregated over
    # 256 poses killed 75% of a 4 m ramp correction at 32k).
    eps_c = 1e-8 * jnp.max(jnp.diagonal(Hc)) + 1e-12
    Hc = Hc + eps_c * jnp.eye(n6, dtype=dtype)
    # same equilibration story as the mid levels, worse: the
    # dense coarsest aggregates stride^levels poses per
    # supernode (pivots ~1e13 at stride 4096 vs the 1e4
    # gauge prior), far beyond f32 Cholesky's range. The
    # regularizer on the unit-diagonal form must sit BELOW
    # the equilibrated smooth-mode eigenvalue
    # (~(pi/2C)^2 * w / diag): 1e-5 ate 10% of the smooth
    # correction at C=128; 1e-6 + one refinement step in
    # coarse_apply brings the solve error to <1%.
    sc = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(Hc), 1e-20))
    Hc_eq = Hc * sc[:, None] * sc[None, :] + 1e-6 * jnp.eye(
        n6, dtype=dtype
    )
    # Shift ladder: the Galerkin coarse matrix is PSD in
    # exact arithmetic, but when most supernodes are EMPTY
    # (fixed-capacity pose arrays at low occupancy — e.g. a
    # fresh fleet with 70 active poses in an 8192-slot
    # array) the equilibrated matrix is nearly rank-
    # deficient and f32 assembly noise drives its smallest
    # eigenvalues negative past the 1e-6 shift (measured:
    # -2e-3 -> Cholesky NaN -> NaN poses in the live fleet
    # drain). Escalate the shift until the factorization is
    # finite; if even the largest fails, drop the coarse
    # term entirely (the additive preconditioner stays SPD
    # without it, and x0/post-correction recompute honest
    # residuals around whatever coarse_apply returns).
    eyen = jnp.eye(n6, dtype=dtype)
    Lc = jnp.linalg.cholesky(Hc_eq)
    for shift in (1e-3, 1e-1):
        retry = jnp.linalg.cholesky(Hc_eq + shift * eyen)
        bad = jnp.any(jnp.isnan(Lc))
        Lc = jnp.where(bad, retry, Lc)
    coarse_ok = jnp.where(jnp.any(jnp.isnan(Lc)), 0.0, 1.0).astype(dtype)
    Lc = jnp.where(jnp.isnan(Lc), eyen, Lc)

    def coarse_apply(v):
        """P A_c^-1 P^T v — the dense coarsest-level solve alone.

        Rigid-body+hat restriction/prolongation (see assembly note).
        One iterative-refinement step (in the equilibrated space)
        halves the f32 Cholesky's smooth-mode solve error; the
        operator stays symmetric PSD (2A^-1 - A^-1 H A^-1 with
        spec(A^-1 H) <= 1 under the positive shift)."""
        vc = (
            jnp.zeros((C, 6), v.dtype)
            .at[cn0].add(jnp.einsum("nab,na->nb", P0, v))
            .at[cn1].add(jnp.einsum("nab,na->nb", P1, v))
        )
        r_eq = sc * vc.reshape(-1)
        y = jax.scipy.linalg.cho_solve((Lc, True), r_eq)
        y = y + jax.scipy.linalg.cho_solve(
            (Lc, True), r_eq - Hc_eq @ y
        )
        yc = (y * sc).reshape(C, 6) * coarse_ok
        return jnp.einsum("nab,nb->na", P0, yc[cn0]) + jnp.einsum(
            "nab,nb->na", P1, yc[cn1]
        )

    return coarse_apply


def auto_coarse(n_poses: int) -> tuple[int, int]:
    """Preconditioner hierarchy from pose count (coarse_stride = -1).

    Block-Jacobi CG needs O(N) iterations to carry a loop correction across
    an N-pose chain, so beyond ~2k poses a coarse hierarchy is mandatory —
    the city-scale preset should not require hand-tuning (VERDICT r1 §8).
    Rule: stride 16, with enough levels that the dense coarsest grid stays
    <= 256 supernodes. Small C is a PRECISION requirement, not a cost one:
    the f32 coarse Cholesky's smooth-mode solve error grows with the coarse
    grid's own condition ((2C/pi)^2) — C=512 leaves ~9% of a long-range
    correction unresolved where C=128 leaves <1% (and 1536^2 is one small
    dense factor, far inside the int32 flat-index bound of the assembly)."""
    if n_poses <= 2048:
        return 0, 1
    stride, levels = 16, 1
    while n_poses / stride**levels > 256:
        levels += 1
    return stride, levels


@partial(
    jax.jit,
    static_argnames=("gn_iters", "cg_iters", "coarse_stride", "coarse_levels"),
)
def solve(
    g: F.FactorGraph,
    poses: se3.Pose,
    gn_iters: int = 10,
    cg_iters: int = 64,
    damping: float = 1e-6,
    huber_delta: float = 1e9,
    coarse_stride: int = 0,
    coarse_levels: int = 1,
) -> SolveResult:
    """Damped Gauss-Newton with PCG inner solves.

    ``poses`` is the full fixed-capacity pose array; slots without factors
    are held in place by damping (zero gradient, zero update). ``huber_delta``
    in units of weighted residual norm; 1e9 disables the robust kernel.

    ``coarse_stride`` > 0 enables a two-level preconditioner for long
    trajectories: block-Jacobi alone needs O(N) CG iterations to carry a
    loop-closure correction across an N-pose odometry chain (the classic 1-D
    Laplacian bound), so every ``coarse_stride`` consecutive poses are
    aggregated into one supernode, the Galerkin coarse Hessian PᵀHP is built
    densely by segment scatter (a [C·6, C·6] matrix — one dense Cholesky), and
    M⁻¹ = blockJacobi + P A_c⁻¹ Pᵀ (additive, SPD). Long-range modes then
    converge in O(1) iterations regardless of trajectory length.

    ``coarse_levels`` > 1 turns the two-level scheme into an additive
    multilevel (BPX-style) hierarchy: level l aggregates ``coarse_stride**l``
    consecutive poses; intermediate levels contribute block-Jacobi solves of
    their Galerkin supernode diagonals and only the coarsest level builds the
    dense PᵀHP Cholesky. This keeps the dense factor small when trajectories
    outgrow what one dense coarse solve can cover (10^5+ poses: stride 16,
    3 levels → a 10^5/16³ ≈ 25-supernode dense solve instead of 6k).
    M⁻¹ = Σ_l P_l D_l⁻¹ P_lᵀ + P_L A_L⁻¹ P_Lᵀ stays SPD for CG.

    ``coarse_stride = -1`` (the config default) selects the hierarchy
    automatically from the pose count (:func:`auto_coarse`) — resolved at
    trace time, since the capacity is static.
    """
    n_poses = poses.t.shape[0]
    if coarse_stride < 0:
        coarse_stride, coarse_levels = auto_coarse(n_poses)
    eye6 = jnp.eye(6, dtype=poses.t.dtype)

    def gn_step(carry, _):
        cur_poses = carry

        r_e, JiT, JjT, w_e, r_p, JpT, w_p = _linearize(g, cur_poses, huber_delta)

        # block diagonal of J^T W J, and the damping blocks that keep
        # factor-less pose slots invertible and condition the solve
        Hi = jnp.einsum("abe,ea,ace->ebc", JiT, w_e, JiT)
        Hj = jnp.einsum("abe,ea,ace->ebc", JjT, w_e, JjT)
        Hp = jnp.einsum("abp,pa,acp->pbc", JpT, w_p, JpT)
        H_diag = jnp.zeros((n_poses, 6, 6), JiT.dtype)
        H_diag = H_diag.at[g.i].add(Hi).at[g.j].add(Hj).at[g.prior_idx].add(Hp)
        mag = jnp.maximum(jax.vmap(jnp.diag)(H_diag).max(-1), 1.0)
        damp_blocks = (damping * mag + 1e-6)[:, None, None] * eye6
        D = H_diag + damp_blocks

        # rhs b = -J^T W r
        b = jnp.zeros((n_poses, 6), poses.t.dtype)
        b = b.at[g.i].add(-jnp.einsum("abe,ea->eb", JiT, w_e * r_e))
        b = b.at[g.j].add(-jnp.einsum("abe,ea->eb", JjT, w_e * r_e))
        b = b.at[g.prior_idx].add(-jnp.einsum("abp,pa->pb", JpT, w_p * r_p))

        # block-Jacobi preconditioner: exact 6x6 Cholesky solves
        L = jnp.linalg.cholesky(D)

        if coarse_stride > 0:
            Hij = jnp.einsum("abe,ea,ace->ebc", JiT, w_e, JjT)
            jacobi_levels = []  # (cidx [N], Ll [C,6,6] cholesky) per mid level
            for lvl in range(1, coarse_levels + 1):
                stride_l = coarse_stride ** lvl
                C = (n_poses + stride_l - 1) // stride_l
                cidx = jnp.arange(n_poses) // stride_l           # [N]
                ci, cj, cp = cidx[g.i], cidx[g.j], cidx[g.prior_idx]
                if lvl < coarse_levels:
                    # Galerkin supernode DIAGONAL only: the two self blocks
                    # always land on the diagonal; the cross blocks do when
                    # both endpoints share a supernode (intra-supernode
                    # odometry edges — the vast majority at small strides).
                    # Row C is the dump slot for inter-supernode edges.
                    same = ci == cj
                    Dl = jnp.zeros((C + 1, 6, 6), JiT.dtype)
                    Dl = Dl.at[ci].add(Hi).at[cj].add(Hj).at[cp].add(Hp)
                    dump = jnp.where(same, ci, C)
                    sym = Hij + jnp.swapaxes(Hij, 1, 2)
                    Dl = Dl.at[dump].add(sym)
                    Dl = Dl[:C].at[cidx].add(damp_blocks)
                    # symmetric Jacobi equilibration before the f32 Cholesky:
                    # supernode blocks aggregate stride_l edges of weight up
                    # to 1/sigma^2 * lever^2 — raw pivots overflow f32's
                    # ~1e7 usable condition range at large strides (observed
                    # NaN at stride 4096 on a 2 km loop). Unit-diagonal form
                    # keeps the factorization in range; the solve un-scales.
                    sl = jax.lax.rsqrt(
                        jnp.maximum(
                            jnp.diagonal(Dl, axis1=1, axis2=2), 1e-20
                        )
                    )                                            # [C, 6]
                    Dl_eq = Dl * sl[:, :, None] * sl[:, None, :] + 1e-5 * eye6
                    # same f32-noise escalation as the dense coarsest level
                    # (empty supernodes at low occupancy); a block whose
                    # factorization stays NaN falls back to identity
                    Ll = jnp.linalg.cholesky(Dl_eq)
                    badb = jnp.any(
                        jnp.isnan(Ll), axis=(-2, -1), keepdims=True
                    )
                    Ll = jnp.where(
                        badb, jnp.linalg.cholesky(Dl_eq + 1e-2 * eye6), Ll
                    )
                    Ll = jnp.where(jnp.isnan(Ll), eye6, Ll)
                    jacobi_levels.append((cidx, sl, Ll))
                else:
                    # Coarsest: dense Galerkin PᵀHP, one Cholesky —
                    # assembly, transfer operators, equilibration, and the
                    # f32 shift ladder live in make_dense_coarse (shared
                    # with the factor-sharded distributed solver)
                    coarse_apply = make_dense_coarse(
                        cur_poses, JiT, JjT, JpT, w_e, w_p,
                        g.i, g.j, g.prior_idx, n_poses, stride_l,
                    )

            def precond(v):
                z = jax.scipy.linalg.cho_solve((L, True), v[..., None])[..., 0]
                for cidx_l, sl, Ll in jacobi_levels:
                    vc = jnp.zeros((Ll.shape[0], 6), v.dtype).at[cidx_l].add(v)
                    zc = (
                        jax.scipy.linalg.cho_solve(
                            (Ll, True), (sl * vc)[..., None]
                        )[..., 0]
                        * sl
                    )
                    z = z + zc[cidx_l]
                return z + coarse_apply(v)
        else:
            coarse_apply = None

            def precond(v):
                return jax.scipy.linalg.cho_solve((L, True), v[..., None])[..., 0]

        def Hx(v):
            return _apply_H(v, g, JiT, JjT, w_e, JpT, w_p, damp_blocks)

        # PCG (fixed iterations, masked convergence).
        #
        # COARSE-FIRST START: seed CG with the exact coarsest-level solve
        # (x0 = P A_c^-1 P^T b) instead of 0. This is not an optimization —
        # it is what makes long chains SOLVABLE in f32: the smooth modes of
        # an N-pose chain have relative eigenvalues ~ (pi/2N)^2, below f32
        # matvec noise for N >~ 5k, so CG's H·p products cannot resolve
        # them no matter the preconditioner (measured: a 4 m kink at 32k
        # poses stayed 4 m after 512 additive-PCG iterations — and even
        # f64 additive PCG needs O(N) iterations). The direct coarse
        # solve reads the smooth correction straight off b, where it is
        # well-represented; CG then only handles the remaining mid/fine
        # scales, which sit inside f32 range. (Galerkin exactness makes
        # P^T r0 = 0 up to roundoff.)
        if coarse_stride > 0:
            x0 = coarse_apply(b)
            r0 = b - Hx(x0)
        else:
            x0 = jnp.zeros_like(b)
            r0 = b
        z0 = precond(r0)
        p0 = z0

        def cg_step(cg, _):
            x, r, z, p, rz = cg
            Ap = Hx(p)
            pAp = jnp.sum(p * Ap)
            alpha = rz / jnp.maximum(pAp, 1e-30)
            x2 = x + alpha * p
            r2 = r - alpha * Ap
            z2 = precond(r2)
            rz2 = jnp.sum(r2 * z2)
            beta = rz2 / jnp.maximum(rz, 1e-30)
            p2 = z2 + beta * p
            return (x2, r2, z2, p2, rz2), None

        rz_init = jnp.sum(r0 * z0)
        (dx, r_fin, _, _, _), _ = jax.lax.scan(
            cg_step, (x0, r0, z0, p0, rz_init), None, length=cg_iters
        )
        if coarse_stride > 0:
            # POST coarse correction (the V-cycle closing leg): the smooth
            # modes' energies sit below f32 CG's arithmetic noise, so the
            # Krylov iterations drift the coarse-space component O(1) per
            # step even from an exact start (measured: the 4 m ramp
            # correction, exact at cg=0, was fully undone by cg=8). One
            # direct coarse solve of the final residual restores the
            # coarse-space component, leaving CG responsible only for the
            # mid/fine scales it actually converges.
            #
            # The residual must be taken against the UNDAMPED operator: an
            # N-pose chain's smooth eigenvalue (~w*(pi/2N)^2, 2e-5 at 32k)
            # sits far below any realizable per-pose damping (1e-6*diag
            # ~ 0.02), so the damped system's smooth minimum is ~lambda/
            # (lambda+d) — a few percent — of the true correction. Damping
            # exists for factor-less-slot invertibility and local
            # conditioning, both fine-scale concerns; the coarse solve
            # handles the scales damping distorts.
            damp_dx = jnp.einsum("nab,nb->na", damp_blocks, dx)
            dx = dx + coarse_apply(b - (Hx(dx) - damp_dx))

        new_poses = se3.retract(cur_poses, dx)
        stats = (
            F.chi2(g, new_poses),
            jnp.linalg.norm(r_fin),
            jnp.linalg.norm(dx),
        )
        return new_poses, stats

    chi2_0 = F.chi2(g, poses)
    final_poses, (chi2s, cg_res, dnorms) = jax.lax.scan(
        gn_step, poses, None, length=gn_iters
    )
    return SolveResult(
        poses=final_poses,
        chi2_history=jnp.concatenate([chi2_0[None], chi2s]),
        cg_residuals=cg_res,
        delta_norms=dnorms,
    )

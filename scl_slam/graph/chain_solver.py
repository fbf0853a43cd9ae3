"""Exact direct pose-graph solver for chains + loop closures.

SLAM pose graphs are odometry CHAINS plus a sparse set of LOOP factors —
the reference's graphs have exactly this shape (``BetweenFactor`` chains per
robot + loop/inter-robot factors, ``include/distributedMapping.h:681-706,
784-823``). This module exploits that structure to compute the EXACT
Gauss-Newton step in O(N + L^2) with accelerator-shaped primitives (cumulative sums
+ one small dense Cholesky), replacing iterative PCG for the single-device
drain.

Why not PCG: an N-pose chain's smooth modes have relative eigenvalues
~(pi/2N)^2 — below f32 matvec noise for N >~ 5k — so no f32 Krylov method
can propagate a loop correction across a long chain, with or without
preconditioning (measured in round 2: a 4 m kink at 32k poses survived 512
multilevel-PCG iterations; even f64 block-Jacobi PCG needs O(N) iterations).
A direct method in a basis where the chain is block-diagonal sidesteps the
conditioning entirely.

The construction (gauge-invariant increment basis + Woodbury):

1. Express each pose's correction as a WORLD twist z_k = Ad(T_k) xi_k
   (xi_k is the body twist the right-multiplicative ``se3.retract``
   applies). Reparametrize to chain increments delta_k = z_k - z_{k-1}
   within each chain segment (z = segmented prefix-sum of delta).
2. A between-factor's residual is invariant to a COMMON world twist of both
   endpoints (left-multiplying both poses by the same rigid motion), so its
   linearization in z is E_i z_i + E_j z_j with E_i = -E_j EXACTLY. A chain
   edge (k-1 -> k) therefore depends on delta_k alone -> the odometry part
   of the normal matrix is BLOCK DIAGONAL (D). A loop factor (a, b) depends
   only on z_b - z_a = a signed pair of prefix intervals of delta -> a rank-6
   row. Priors depend on z_p = one prefix interval.
3. Normal equations in delta: (D + U^T W U) delta = c with U holding one
   6-row block per loop/prior. Solve by Woodbury:
       delta = D^-1 c - D^-1 U^T (W^-1 + U D^-1 U^T)^-1 U D^-1 c
   Every U-product reduces to differences of prefix sums of D^-1 (interval
   algebra), and the capacitance matrix is 6(L+P) square — one dense
   Cholesky. No iteration, no conditioning cliff: the step is the exact
   Newton step for the damped linearization.

Cross-robot loops work unchanged: each robot block is its own segment, and
a loop row carries the signed intervals (segment_start(b), b] and
(segment_start(a), a] — the gauge-invariance argument holds per endpoint.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from . import factors as F
from .solver import _linearize


class ChainSolveResult(NamedTuple):
    poses: se3.Pose
    chi2_history: jax.Array   # [gn_iters + 1]
    delta_norms: jax.Array    # [gn_iters]
    loop_overflow: jax.Array  # bool: more non-chain factors than loop_capacity


def _segment_structure(g: F.FactorGraph, n_poses: int):
    """Chain segmentation from the graph itself.

    A pose k has a chain parent iff a valid edge (k-1 -> k) exists; poses
    without one start a new segment (robot-block starts, factor-less
    slots). Returns (chain_edge [E] bool, seg_start [N] int32 — the index
    of pose k's segment start)."""
    valid = g.edge_mask()
    chain_edge = valid & (g.j == g.i + 1)
    has_parent = (
        jnp.zeros(n_poses + 1, bool)
        .at[jnp.where(chain_edge, g.j, n_poses)]
        .set(True, mode="drop")[:n_poses]
    )
    ar = jnp.arange(n_poses, dtype=jnp.int32)
    start_marks = jnp.where(~has_parent, ar, -1)
    seg_start = jax.lax.associative_scan(jnp.maximum, start_marks)
    return chain_edge, seg_start


@partial(
    jax.jit, static_argnames=("gn_iters", "loop_capacity")
)
def chain_solve(
    g: F.FactorGraph,
    poses: se3.Pose,
    gn_iters: int = 6,
    loop_capacity: int = 256,
    damping: float = 1e-6,
    huber_delta: float = 1e9,
) -> ChainSolveResult:
    """Exact damped Gauss-Newton for chain+loop graphs (see module doc).

    ``loop_capacity``: static bound on non-chain factors (loops + any
    stray edges). When exceeded, ``loop_overflow`` is True and rows past
    the capacity are EXCLUDED from the solve (their factors remain in the
    graph). This solver is currently the offline/exact reference path
    (``docs/solver_scaling.md``) — the runtime drain uses
    ``graph/solver.py::solve`` — so any caller must check
    ``loop_overflow`` itself and fall back (e.g. to ``solver.solve``)
    rather than silently dropping loop factors past the capacity.
    """
    n_poses = poses.t.shape[0]
    E = g.edge_capacity
    P = g.prior_capacity
    LR = loop_capacity + P
    dtype = poses.t.dtype
    eye6 = jnp.eye(6, dtype=dtype)

    chain_edge, seg_start = _segment_structure(g, n_poses)
    valid = g.edge_mask()
    is_loop = valid & ~chain_edge
    loop_overflow = jnp.sum(is_loop) > loop_capacity
    # stable selection of loop rows (loops first, then padding)
    order = jnp.argsort(~is_loop, stable=True)
    loop_ids = order[:loop_capacity]
    loop_valid = is_loop[loop_ids]

    def gn_step(carry, _):
        cur = carry
        r_e, JiT, JjT, w_e, r_p, JpT, w_p = _linearize(g, cur, huber_delta)

        # rhs in the body-twist (dx) basis, as in solver.solve
        b = jnp.zeros((n_poses, 6), dtype)
        b = b.at[g.i].add(-jnp.einsum("abe,ea->eb", JiT, w_e * r_e))
        b = b.at[g.j].add(-jnp.einsum("abe,ea->eb", JjT, w_e * r_e))
        b = b.at[g.prior_idx].add(-jnp.einsum("abp,pa->pb", JpT, w_p * r_p))

        # world-twist conversion: Ad(T_k)^-1 per pose
        ad_inv = se3.adjoint(se3.inverse(cur))          # [N, 6, 6]

        # --- block-diagonal chain part: D[j] += E^T W E, E = Jj Ad^-1_j ---
        Jj_e = jnp.transpose(JjT, (2, 0, 1))             # [E, 6, 6]
        E_e = jnp.einsum("eab,ebc->eac", Jj_e, ad_inv[g.j])
        w_chain = w_e * chain_edge[:, None]
        D = jnp.zeros((n_poses, 6, 6), dtype)
        D = D.at[g.j].add(
            jnp.einsum("eab,ea,eac->ebc", E_e, w_chain, E_e)
        )

        # PRIORS AT SEGMENT STARTS fold into D (exactly): such a prior's
        # interval is the single increment delta_p, and leaving it in U is
        # numerically catastrophic — delta_p would be constrained only
        # through the Woodbury cancellation D^-1(c - U^T lam) with
        # D_p = damping (~1e-6) against prior information up to 1e6, a
        # 1-part-in-1e12 cancellation f32 cannot perform (measured: chi
        # exploded from 8e-9 to 2e5 in one GN step). In the mapper's graphs
        # every prior sits at a robot-block start, so U ends up loops-only.
        Jp_p = jnp.transpose(JpT, (2, 0, 1))              # [P, 6, 6]
        E_p = jnp.einsum("pab,pbc->pac", Jp_p, ad_inv[g.prior_idx])
        prior_at_start = seg_start[g.prior_idx] == g.prior_idx
        w_p_fold = w_p * prior_at_start[:, None]
        w_p_row = w_p * (~prior_at_start)[:, None]
        D = D.at[g.prior_idx].add(
            jnp.einsum("pab,pa,pac->pbc", E_p, w_p_fold, E_p)
        )

        mag = jnp.maximum(jax.vmap(jnp.diag)(D).max(-1), 1.0)
        # segment-start increments are block GAUGES, constrained only by
        # folded priors and loop rows; when neither is present (or loops
        # are weak) the Woodbury cancellation inherits the D^-1 scale, so
        # give starts a mild absolute floor — bias is bounded by
        # 1e-3/loop_info (negligible at any useful loop weight)
        is_start = seg_start == jnp.arange(n_poses, dtype=jnp.int32)
        floor = jnp.where(is_start, 1e-3, 1e-6).astype(dtype)
        D = D + ((damping * mag + floor)[:, None, None]) * eye6
        Dinv = jax.scipy.linalg.cho_solve(
            (jnp.linalg.cholesky(D), True),
            jnp.broadcast_to(eye6, (n_poses, 6, 6)),
        )                                                # [N, 6, 6]

        # --- rhs in the increment basis: segmented suffix sums of Ad^-T b
        u = jnp.einsum("nba,nb->na", ad_inv, b)          # [N, 6]
        suf = jnp.concatenate(
            [jnp.cumsum(u[::-1], axis=0)[::-1], jnp.zeros((1, 6), dtype)]
        )                                                # [N+1, 6]; suf[p] = sum_{k>=p}
        # segment end: (smallest segment-START INDEX > k) - 1
        ar_n = jnp.arange(n_poses, dtype=jnp.int32)
        start_marks = jnp.where(seg_start == ar_n, ar_n, n_poses)
        nxt = jnp.concatenate(
            [start_marks[1:], jnp.full((1,), n_poses, jnp.int32)]
        )
        seg_end = jax.lax.associative_scan(jnp.minimum, nxt[::-1])[::-1] - 1
        c = suf[ar_n] - suf[seg_end + 1]                 # [N, 6]

        # --- loop/prior rows: B [LR,6,6], weights [LR,6], signed intervals
        # (lo, hi] with sum = Phi[hi+1] - Phi[lo+1]
        a_end = g.i[loop_ids]
        b_end = g.j[loop_ids]
        B_loop = E_e[loop_ids]                            # Jj Ad^-1_j at b
        w_loop = jnp.where(loop_valid[:, None], w_e[loop_ids], 0.0)
        # interval 1: (seg_start(b)-1, b], sign +1
        lo1_l, hi1_l = seg_start[b_end] - 1, b_end
        # interval 2: (seg_start(a)-1, a], sign -1
        lo2_l, hi2_l = seg_start[a_end] - 1, a_end
        sgn2_l = jnp.where(loop_valid, -1.0, 0.0)

        B_prior = E_p                                     # Jp Ad^-1_p
        lo1_p = seg_start[g.prior_idx] - 1
        hi1_p = g.prior_idx
        lo2_p = jnp.zeros((P,), jnp.int32)
        hi2_p = jnp.zeros((P,), jnp.int32)                # empty
        sgn2_p = jnp.zeros((P,), dtype)

        B = jnp.concatenate([B_loop, B_prior])            # [LR, 6, 6]
        w_r = jnp.concatenate([w_loop, w_p_row])          # [LR, 6]
        lo = jnp.stack(
            [jnp.concatenate([lo1_l, lo1_p]), jnp.concatenate([lo2_l, lo2_p])],
            axis=1,
        )                                                 # [LR, 2]
        hi = jnp.stack(
            [jnp.concatenate([hi1_l, hi1_p]), jnp.concatenate([hi2_l, hi2_p])],
            axis=1,
        )
        sgn = jnp.stack(
            [
                jnp.concatenate(
                    [
                        loop_valid.astype(dtype),
                        (w_p_row.max(-1) > 0).astype(dtype),
                    ]
                ),
                jnp.concatenate([sgn2_l, sgn2_p]),
            ],
            axis=1,
        )                                                 # [LR, 2]

        # --- capacitance: M = W^-1 + U D^-1 U^T ---
        PhiD = jnp.concatenate(
            [jnp.zeros((1, 6, 6), dtype), jnp.cumsum(Dinv, axis=0)]
        )                                                 # [N+1, 6, 6]
        # pairwise interval intersections over the 2x2 signed combinations
        ilo = jnp.maximum(lo[:, None, :, None], lo[None, :, None, :])
        ihi = jnp.minimum(hi[:, None, :, None], hi[None, :, None, :])
        cut_hi = jnp.maximum(ihi + 1, ilo + 1)            # empty -> equal
        G = (PhiD[cut_hi] - PhiD[ilo + 1]) * (
            sgn[:, None, :, None] * sgn[None, :, None, :]
        )[..., None, None]
        G = G.sum(axis=(2, 3))                            # [LR, LR, 6, 6]
        Cap = jnp.einsum("lab,lmbc,mdc->lamd", B, G, B).reshape(
            LR * 6, LR * 6
        )
        # W^-1 on the diagonal; invalid rows get a huge W^-1 (-> lambda ~ 0,
        # the natural Woodbury way to mask rows without reshaping)
        w_diag = jnp.where(w_r > 0, w_r, 1e-30).reshape(-1)
        Cap = Cap + jnp.diag(1.0 / w_diag)
        Cap = 0.5 * (Cap + Cap.T)

        # rhs of the capacitance system: U D^-1 c
        Dc = jnp.einsum("nab,nb->na", Dinv, c)            # [N, 6]
        PhiDc = jnp.concatenate(
            [jnp.zeros((1, 6), dtype), jnp.cumsum(Dc, axis=0)]
        )
        seg_sum = (
            (PhiDc[hi + 1] - PhiDc[lo + 1]) * sgn[..., None]
        ).sum(axis=1)                                     # [LR, 6]
        rho = jnp.einsum("lab,lb->la", B, seg_sum).reshape(-1)

        # Equilibrated Cholesky + iterative refinement. The capacitance is
        # the prior marginal covariance of the loop gaps — intrinsically
        # ill-conditioned for long chains (yaw-lever^2 terms grow ~N^3 vs
        # ~N for translations), so the regularizer must sit at the dtype's
        # noise floor and refinement must run a few steps (each reduces the
        # error by ~cond*eps; it converges whenever cond*eps < 1).
        reg = 4e-7 if dtype == jnp.float32 else 1e-13
        scap = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(Cap), 1e-30))
        Cap_eq = Cap * scap[:, None] * scap[None, :] + reg * jnp.eye(
            LR * 6, dtype=dtype
        )
        Lcap = jnp.linalg.cholesky(Cap_eq)
        r_eq = scap * rho
        y = jax.scipy.linalg.cho_solve((Lcap, True), r_eq)
        for _ in range(3):
            y = y + jax.scipy.linalg.cho_solve(
                (Lcap, True), r_eq - Cap_eq @ y
            )
        lam = (y * scap).reshape(LR, 6)

        # U^T lam via the difference-array trick, then delta and z
        v = jnp.einsum("lba,lb->la", B, lam)              # [LR, 6] B^T lam
        acc = jnp.zeros((n_poses + 1, 6), dtype)
        for s in range(2):
            vs = v * sgn[:, s, None]
            acc = acc.at[lo[:, s] + 1].add(vs, mode="drop")
            acc = acc.at[hi[:, s] + 1].add(-vs, mode="drop")
        ut_lam = jnp.cumsum(acc[:-1], axis=0)             # [N, 6]

        delta = jnp.einsum("nab,nb->na", Dinv, c - ut_lam)
        Phi_d = jnp.concatenate(
            [jnp.zeros((1, 6), dtype), jnp.cumsum(delta, axis=0)]
        )
        z = Phi_d[jnp.arange(n_poses) + 1] - Phi_d[seg_start]
        dx = jnp.einsum("nab,nb->na", ad_inv, z)

        new_poses = se3.retract(cur, dx)
        return new_poses, (F.chi2(g, new_poses), jnp.linalg.norm(dx))

    chi2_0 = F.chi2(g, poses)
    final, (chis, dnorms) = jax.lax.scan(gn_step, poses, None, length=gn_iters)
    return ChainSolveResult(
        poses=final,
        chi2_history=jnp.concatenate([chi2_0[None], chis]),
        delta_norms=dnorms,
        loop_overflow=loop_overflow,
    )

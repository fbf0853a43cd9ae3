"""Multi-device sharding: descriptor retrieval and pose-graph solves over a

``jax.sharding.Mesh``.

JAX replacement for the reference's multi-robot distribution story
(``robust_distributed_mapper`` message-passing Gauss-Seidel + ROS topics,
reference ``include/distributedMapping.h:825-880``, SURVEY §2.3): instead of
per-robot processes exchanging subgraph estimates, the global problem is laid
out across devices —

- the **descriptor DB is sharded by rows** (keyframe ranges per device, the
  "long context" axis of SURVEY §5): queries broadcast, each shard computes
  its local top-k, and a gathered k*D candidate set reduces to the global
  top-k. Communication: one small all-gather per query batch.
- the **factor graph is sharded by edges** (factor-parallel): poses replicate,
  each device computes J^T W J x for its edge shard, and a ``psum`` reduces
  the Gauss-Newton products inside PCG. This subsumes the reference's
  per-robot alternating solves: a robot's trajectory is just an edge range.

Both are expressed with ``shard_map`` so collectives are explicit; XLA hands
them to the device interconnect (NCCL on GPUs).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import se3
from ..graph import factors as F

# ---------------------------------------------------------------------------
# sharded retrieval
# ---------------------------------------------------------------------------


def sharded_topk(mesh: Mesh, axis: str, db_keys, query_key, mask, k: int):
    """Global top-k nearest keys over a row-sharded DB.

    ``db_keys`` [N, D] sharded on rows; ``query_key`` [D] and ``mask`` [N]
    (sharded like the DB). Returns (d2 [k], global_pos [k]) replicated.
    """
    n = db_keys.shape[0]
    n_dev = mesh.shape[axis]
    shard_rows = n // n_dev

    def local(db_shard, q, m_shard):
        # db_shard: [n/d, D]; local top-k then gather candidates
        d2 = jnp.sum((db_shard - q[None, :]) ** 2, axis=-1)
        d2 = jnp.where(m_shard, d2, jnp.inf)
        neg, pos = jax.lax.top_k(-d2, k)
        my = jax.lax.axis_index(axis)
        gpos = pos + my * shard_rows
        # gather all shards' candidates: [n_dev * k]
        all_d2 = jax.lax.all_gather(-neg, axis).reshape(-1)
        all_pos = jax.lax.all_gather(gpos, axis).reshape(-1)
        neg2, sel = jax.lax.top_k(-all_d2, k)
        return -neg2, all_pos[sel]

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(), P(axis)),
        out_specs=(P(), P()),
        # outputs are value-replicated via the all_gather; the static VMA
        # check can't see that through the axis_index arithmetic
        check_vma=False,
    )(db_keys, query_key, mask)


# ---------------------------------------------------------------------------
# factor-sharded distributed Gauss-Newton
# ---------------------------------------------------------------------------


def _edge_shard_specs(axis: str):
    """PartitionSpecs for a FactorGraph with edges sharded, priors replicated."""
    return F.FactorGraph(
        i=P(axis),
        j=P(axis),
        z=se3.Pose(P(axis), P(axis)),
        sqrt_info=P(axis),
        num_edges=P(),
        prior_idx=P(),
        prior_z=se3.Pose(P(), P()),
        prior_sqrt_info=P(),
        num_priors=P(),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "gn_iters", "cg_iters", "coarse_stride",
        "coarse_levels",
    ),
)
def sharded_solve(
    mesh: Mesh,
    axis: str,
    g: F.FactorGraph,
    poses: se3.Pose,
    gn_iters: int = 8,
    cg_iters: int = 48,
    damping: float = 1e-6,
    gamma: float = 1.0,
    rotation_change_threshold: float = 0.0,
    pose_change_threshold: float = 0.0,
    coarse_stride: int = -1,
    coarse_levels: int = 1,
):
    """Distributed GN: edges sharded across ``axis``, poses replicated.

    Each device linearizes its own edge shard and applies its partial
    J^T W J; a single ``psum`` per CG step reduces the products. The edge
    validity mask uses *global* edge ids so sharding doesn't change
    semantics. Returns (poses, chi2_history).

    The reference's ``distributedOptimizer`` contract
    (``include/distributedMapping.h:878-880, 525-535``) is honored here:
    ``gamma`` over-relaxes each GN update (new = retract(cur, gamma*dx)),
    and iteration FREEZES once the largest per-pose update drops below both
    change thresholds (rotation: |dx[:, :3]| in rad; translation:
    |dx[:, 3:]| in m — the ``rotThres``/``poseThres`` early-stop). The scan
    length stays static (XLA needs it); converged iterations become no-ops,
    which is the fixed-cost equivalent of the reference's early break. A
    threshold <= 0 makes its test always-pass (so e.g. rotation_change
    _threshold=0 gives translation-only stopping); if BOTH are <= 0 the
    early-stop is disabled entirely and all ``gn_iters`` run.

    ``coarse_stride``/``coarse_levels``: block-Jacobi CG needs O(N)
    iterations to carry a loop correction across an N-pose chain, exactly
    like the single-device solver — so the same dense Galerkin coarsest
    level (``graph.solver.make_dense_coarse``) seeds and closes every CG
    solve here too. Each device assembles its EDGE SHARD's contribution
    and one ``psum`` makes the dense matrix global; the factorization and
    coarse solves are replicated math. -1 (default) auto-selects from the
    pose count (``auto_coarse``, collapsed to one dense level at
    ``stride**levels``); 0 disables. Unlike ``solve`` there are no
    intermediate Jacobi levels — at mesh scales the two-level additive
    form already makes long-range corrections O(1) in CG iterations.
    """
    from ..graph.solver import (
        _edge_jac,
        _edge_residual,
        _prior_jac,
        _prior_residual,
        auto_coarse,
        make_dense_coarse,
    )

    n_poses = poses.t.shape[0]
    if coarse_stride < 0:
        coarse_stride, coarse_levels = auto_coarse(n_poses)
    stride_l = coarse_stride ** coarse_levels if coarse_stride > 0 else 0
    E = g.edge_capacity
    n_dev = mesh.shape[axis]
    eshard = E // n_dev
    eye6 = jnp.eye(6, dtype=poses.t.dtype)

    def worker(
        gi, gj, gzR, gzt, gsq, n_edges, p_idx, pzR, pzt, psq, n_priors,
        R, t, gam, rthres, pthres,
    ):
        my = jax.lax.axis_index(axis)
        global_eid = jnp.arange(eshard) + my * eshard
        emask = global_eid < n_edges
        pmask = jnp.arange(p_idx.shape[0]) < n_priors
        # only device 0 contributes priors (they are replicated)
        pmask = pmask & (my == 0)

        cur = se3.Pose(R, t)

        def linearize(cur):
            zeros6 = jnp.zeros((eshard, 6), t.dtype)
            Ti = se3.take(cur, gi)
            Tj = se3.take(cur, gj)
            r_e = jax.vmap(_edge_residual)(
                zeros6, zeros6, Ti.R, Ti.t, Tj.R, Tj.t, gzR, gzt
            )
            Ji, Jj = _edge_jac(zeros6, zeros6, Ti.R, Ti.t, Tj.R, Tj.t, gzR, gzt)
            w_e = (gsq ** 2) * emask[:, None]

            zerosP = jnp.zeros((p_idx.shape[0], 6), t.dtype)
            Tp = se3.take(cur, p_idx)
            r_p = jax.vmap(_prior_residual)(zerosP, Tp.R, Tp.t, pzR, pzt)
            Jp = _prior_jac(zerosP, Tp.R, Tp.t, pzR, pzt)
            w_p = (psq ** 2) * pmask[:, None]
            return r_e, Ji, Jj, w_e, r_p, Jp, w_p

        def gn_step(carry, _):
            cur, done = carry
            r_e, Ji, Jj, w_e, r_p, Jp, w_p = linearize(cur)

            # local block-diagonal + rhs, then psum to global
            Hi = jnp.einsum("eab,ea,eac->ebc", Ji, w_e, Ji)
            Hj = jnp.einsum("eab,ea,eac->ebc", Jj, w_e, Jj)
            Hp = jnp.einsum("pab,pa,pac->pbc", Jp, w_p, Jp)
            H_diag = jnp.zeros((n_poses, 6, 6), t.dtype)
            H_diag = H_diag.at[gi].add(Hi).at[gj].add(Hj).at[p_idx].add(Hp)
            H_diag = jax.lax.psum(H_diag, axis)

            b = jnp.zeros((n_poses, 6), t.dtype)
            b = b.at[gi].add(-jnp.einsum("eab,ea->eb", Ji, w_e * r_e))
            b = b.at[gj].add(-jnp.einsum("eab,ea->eb", Jj, w_e * r_e))
            b = b.at[p_idx].add(-jnp.einsum("pab,pa->pb", Jp, w_p * r_p))
            b = jax.lax.psum(b, axis)

            mag = jnp.maximum(jax.vmap(jnp.diag)(H_diag).max(-1), 1.0)
            damp = (damping * mag + 1e-6)[:, None, None] * eye6
            D = H_diag + damp
            L = jnp.linalg.cholesky(D)

            if stride_l > 0:
                # dense coarsest level, assembled from this device's edge
                # shard and psum-reduced (see docstring). Note the helper
                # takes TRANSPOSED [6, 6, E] blocks.
                coarse_apply = make_dense_coarse(
                    cur,
                    jnp.transpose(Ji, (1, 2, 0)),
                    jnp.transpose(Jj, (1, 2, 0)),
                    jnp.transpose(Jp, (1, 2, 0)),
                    w_e, w_p, gi, gj, p_idx, n_poses, stride_l,
                    psum_axis=axis,
                )

                def precond(v):
                    z = jax.scipy.linalg.cho_solve(
                        (L, True), v[..., None]
                    )[..., 0]
                    return z + coarse_apply(v)
            else:
                coarse_apply = None

                def precond(v):
                    return jax.scipy.linalg.cho_solve(
                        (L, True), v[..., None]
                    )[..., 0]

            def Hx(v):
                u = (
                    jnp.einsum("eab,eb->ea", Ji, v[gi])
                    + jnp.einsum("eab,eb->ea", Jj, v[gj])
                ) * w_e
                y = jnp.zeros_like(v)
                y = y.at[gi].add(jnp.einsum("eab,ea->eb", Ji, u))
                y = y.at[gj].add(jnp.einsum("eab,ea->eb", Jj, u))
                up = jnp.einsum("pab,pb->pa", Jp, v[p_idx]) * w_p
                y = y.at[p_idx].add(jnp.einsum("pab,pa->pb", Jp, up))
                y = jax.lax.psum(y, axis)
                return y + jnp.einsum("nab,nb->na", damp, v)

            # coarse-first CG start + post coarse correction: same f32
            # rationale as graph.solver.solve (smooth modes sit below f32
            # matvec noise; the direct coarse solve reads them off b and
            # restores them after CG's arithmetic drift)
            if coarse_apply is not None:
                x0 = coarse_apply(b)
                r0 = b - Hx(x0)
            else:
                x0 = jnp.zeros_like(b)
                r0 = b
            z0 = precond(r0)

            def cg_step(cg, _):
                x, r, z, p, rz = cg
                Ap = Hx(p)
                alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
                x2 = x + alpha * p
                r2 = r - alpha * Ap
                z2 = precond(r2)
                rz2 = jnp.sum(r2 * z2)
                p2 = z2 + (rz2 / jnp.maximum(rz, 1e-30)) * p
                return (x2, r2, z2, p2, rz2), None

            (dx, *_), _ = jax.lax.scan(
                cg_step, (x0, r0, z0, z0, jnp.sum(r0 * z0)), None,
                length=cg_iters,
            )
            if coarse_apply is not None:
                # V-cycle closing leg against the UNDAMPED operator
                # (graph.solver.solve's post-correction rationale)
                damp_dx = jnp.einsum("nab,nb->na", damp, dx)
                dx = dx + coarse_apply(b - (Hx(dx) - damp_dx))
            # over-relaxed update, frozen once converged (gamma / rotThres /
            # poseThres semantics — see docstring)
            dx = gam * dx
            stepped = se3.retract(cur, dx)
            new = se3.Pose(
                jnp.where(done, cur.R, stepped.R),
                jnp.where(done, cur.t, stepped.t),
            )
            rot_chg = jnp.max(jnp.linalg.norm(dx[:, :3], axis=-1))
            pose_chg = jnp.max(jnp.linalg.norm(dx[:, 3:], axis=-1))
            # a <=0 threshold means "no test on this component" (always
            # passes); if BOTH are <=0 the early-stop is disabled entirely
            # (otherwise every iteration would freeze immediately)
            rok = jnp.where(rthres > 0, rot_chg < rthres, True)
            pok = jnp.where(pthres > 0, pose_chg < pthres, True)
            enabled = (rthres > 0) | (pthres > 0)
            done = done | (enabled & rok & pok)

            # chi2 (global): local residual sums + psum
            chi_local = jnp.sum(
                jnp.sum((r_e * gsq) ** 2, -1) * emask
            ) + jnp.sum(jnp.sum((r_p * psq) ** 2, -1) * pmask)
            chi = jax.lax.psum(chi_local, axis)
            return (new, done), chi

        (final, _), chis = jax.lax.scan(
            gn_step, (cur, jnp.array(False)), None, length=gn_iters
        )
        return final.R, final.t, chis

    specs = _edge_shard_specs(axis)
    out = jax.shard_map(
        worker,
        mesh=mesh,
        in_specs=(
            specs.i, specs.j, P(axis), P(axis), specs.sqrt_info, P(),
            P(), P(), P(), P(), P(),
            P(), P(), P(), P(), P(),
        ),
        out_specs=(P(), P(), P()),
    )(
        g.i, g.j, g.z.R, g.z.t, g.sqrt_info, g.num_edges,
        g.prior_idx, g.prior_z.R, g.prior_z.t, g.prior_sqrt_info, g.num_priors,
        poses.R, poses.t,
        jnp.asarray(gamma, poses.t.dtype),
        jnp.asarray(rotation_change_threshold, poses.t.dtype),
        jnp.asarray(pose_change_threshold, poses.t.dtype),
    )
    R, t, chis = out
    return se3.Pose(R, t), chis

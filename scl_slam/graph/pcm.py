"""Pairwise Consistency Maximization (PCM) outlier rejection.

JAX replacement for the reference's ``distributed_pcm`` +
``fast_max-clique_finder`` libraries (``robust_distributed_mapper``; enabled
by ``usePCM`` with ``pcmThreshold`` 0.75, reference
``include/distributedMapping.h:525-535, 878-880``).

Idea: two inter-robot loop measurements z_ik, z_jl (between robots a and b)
are *pairwise consistent* if the cycle

    z_ik ∘ (b: l -> k)^-1 ∘ z_jl^-1 ∘ (a: i -> j)

composes to ~identity under the odometry estimates. Building the M x M
consistency matrix is a **batched pose-composition kernel** (all pairs at
once); the largest consistent set is the maximum clique, approximated with
the standard degeneracy-ordered greedy heuristic (the reference also uses a
heuristic finder).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3


@partial(jax.jit, static_argnames=())
def consistency_matrix(
    loops_i: se3.Pose,    # [M] poses of anchor keyframe on robot a (odom/opt est)
    loops_j: se3.Pose,    # [M] poses of matched keyframe on robot b
    loops_z: se3.Pose,    # [M] measured relative pose a_i -> b_j
    valid: jax.Array,     # [M] bool
) -> jax.Array:
    """[M, M] squared consistency error between every loop pair.

    err(p, q) = || log( (z_p)^-1 ∘ (a: i_p -> i_q) ∘ z_q ∘ (b: j_q -> j_p) ) ||^2
    computed with all composition terms batched over the M x M grid.
    """
    M = loops_z.t.shape[0]

    def pair(p, q):
        a_rel = se3.between(se3.index(loops_i, p), se3.index(loops_i, q))
        b_rel = se3.between(se3.index(loops_j, q), se3.index(loops_j, p))
        cycle = se3.compose(
            se3.inverse(se3.index(loops_z, p)),
            se3.compose(a_rel, se3.compose(se3.index(loops_z, q), b_rel)),
        )
        return jnp.sum(se3.log(cycle) ** 2)

    idx = jnp.arange(M)
    err = jax.vmap(lambda p: jax.vmap(lambda q: pair(p, q))(idx))(idx)
    both = valid[:, None] & valid[None, :]
    return jnp.where(both, err, jnp.inf)


@partial(jax.jit, static_argnames=("max_iters",))
def greedy_max_clique(adj: jax.Array, max_iters: int = 64) -> jax.Array:
    """Greedy maximum-clique over a boolean adjacency matrix [M, M].

    Degeneracy-style heuristic: repeatedly add the candidate with the most
    connections into the current candidate set. Returns a bool membership
    mask. Fixed iteration count, fully jittable.
    """
    M = adj.shape[0]
    adj = adj & ~jnp.eye(M, dtype=bool)  # no self loops

    def body(state, _):
        in_clique, candidates = state
        # degree of each candidate restricted to the candidate set
        deg = jnp.sum(adj & candidates[None, :], axis=1)
        deg = jnp.where(candidates, deg, -1)
        best = jnp.argmax(deg)
        can_add = candidates[best]
        in_clique = in_clique.at[best].set(in_clique[best] | can_add)
        # new candidates must connect to `best`
        candidates = candidates & adj[best] & (jnp.arange(M) != best)
        candidates = jnp.where(can_add, candidates, jnp.zeros_like(candidates))
        return (in_clique, candidates), None

    init = (jnp.zeros(M, bool), jnp.ones(M, bool))
    (clique, _), _ = jax.lax.scan(body, init, None, length=min(max_iters, M))
    return clique


def pcm_filter(
    loops_i: se3.Pose,
    loops_j: se3.Pose,
    loops_z: se3.Pose,
    valid: jax.Array,
    threshold: float = 0.75,
) -> jax.Array:
    """Accept mask over loops: members of the largest pairwise-consistent set.

    ``threshold`` is the consistency gate on the cycle error norm (the
    reference's ``pcmThreshold`` 0.75, ``distributedMapping.h:533``).
    """
    err = consistency_matrix(loops_i, loops_j, loops_z, valid)
    adj = err < threshold * threshold
    clique = greedy_max_clique(adj)
    return clique & valid

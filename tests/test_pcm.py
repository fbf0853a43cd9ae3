import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3, so3
from scl_slam.graph import pcm


def make_loops(n_good=6, n_bad=3, key=None):
    """Loops between robot a (poses along x) and robot b (offset world)."""
    key = key or jax.random.PRNGKey(0)
    # true relative transform between robot frames: b = T_ab * a
    T_ab = se3.Pose(so3.exp(jnp.array([0.0, 0.0, 0.4])), jnp.array([5.0, -2.0, 0.0]))
    M = n_good + n_bad
    ai, bj, z = [], [], []
    for k in range(M):
        a_pose = se3.Pose(so3.exp(jnp.array([0, 0, 0.1 * k])), jnp.array([2.0 * k, 0.0, 0.0]))
        b_pose = se3.compose(T_ab, a_pose)  # same physical place in b's frame
        ai.append(a_pose)
        bj.append(b_pose)
        if k < n_good:
            noise = se3.exp(jax.random.normal(jax.random.fold_in(key, k), (6,)) * 0.01)
            z.append(se3.compose(se3.between(a_pose, b_pose), noise))
        else:
            bad = se3.exp(
                jax.random.normal(jax.random.fold_in(key, 100 + k), (6,))
                * jnp.array([0.5] * 3 + [8.0] * 3)
            )
            z.append(se3.compose(se3.between(a_pose, b_pose), bad))
    return se3.stack(ai), se3.stack(bj), se3.stack(z), M


class TestPCM:
    def test_consistency_matrix_separates(self):
        ai, bj, z, M = make_loops()
        err = pcm.consistency_matrix(ai, bj, z, jnp.ones(M, bool))
        e = np.asarray(err)
        good = e[:6, :6]
        cross = e[:6, 6:]
        assert np.nanmax(good[np.isfinite(good)]) < 0.1
        assert np.min(cross) > 0.5

    def test_filter_keeps_good_rejects_bad(self):
        ai, bj, z, M = make_loops()
        accept = pcm.pcm_filter(ai, bj, z, jnp.ones(M, bool), threshold=0.5)
        acc = np.asarray(accept)
        assert acc[:6].all(), f"good loops must survive: {acc}"
        assert not acc[6:].any(), f"outliers must be rejected: {acc}"

    def test_invalid_loops_never_accepted(self):
        ai, bj, z, M = make_loops()
        valid = jnp.ones(M, bool).at[0].set(False)
        accept = pcm.pcm_filter(ai, bj, z, valid, threshold=0.5)
        assert not bool(accept[0])

    def test_greedy_clique_simple(self):
        # two cliques: {0,1,2} and {3,4}; must find the bigger one
        adj = np.zeros((5, 5), bool)
        for a, b in [(0, 1), (0, 2), (1, 2), (3, 4)]:
            adj[a, b] = adj[b, a] = True
        clique = np.asarray(pcm.greedy_max_clique(jnp.asarray(adj)))
        assert clique[:3].all() and not clique[3:].any()

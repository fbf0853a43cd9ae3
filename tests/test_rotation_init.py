import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3, so3
from scl_slam.graph import factors as F
from scl_slam.graph import rotation_init, solver

from test_graph import TIGHT_PRIOR, circle_trajectory, pad_poses


def loopy_graph_with_bad_init(n=24, cap=32, key=None):
    """Graph whose measurements are exact but whose initial rotations are

    badly wrong — the regime where plain GN stalls in a local minimum."""
    key = key or jax.random.PRNGKey(0)
    gt = circle_trajectory(n)
    g = F.make_graph(cap)
    g = F.add_prior(g, 0, se3.index(gt, 0), TIGHT_PRIOR)
    for k in range(n - 1):
        z = se3.between(se3.index(gt, k), se3.index(gt, k + 1))
        g = F.add_between(g, k, k + 1, z, [1e2] * 6)
    for a, b in [(n - 1, 0), (n // 2, 0), (n - 1, n // 2)]:
        z = se3.between(se3.index(gt, a), se3.index(gt, b))
        g = F.add_between(g, a, b, z, [1e3] * 6)
    # init: correct translations, random rotations (up to ~120 degrees off)
    bad_R = so3.exp(jax.random.normal(key, (n, 3)) * 1.0)
    init = pad_poses(se3.Pose(bad_R, gt.t), cap)
    return g, init, gt


class TestChordalInit:
    def test_recovers_rotations(self):
        g, init, gt = loopy_graph_with_bad_init()
        out = rotation_init.chordal_rotation_init(g, init)
        n = gt.t.shape[0]
        # relative rotation error to ground truth after averaging
        err = so3.log(
            jnp.einsum("nij,nik->njk", out.R[:n], gt.R)  # R_est^T R_gt
        )
        max_err = float(jnp.abs(err).max())
        assert max_err < 0.1, f"rotations not recovered: {max_err}"

    def test_two_stage_beats_plain_gn_from_bad_init(self):
        g, init, gt = loopy_graph_with_bad_init()
        n = gt.t.shape[0]
        plain = solver.solve(g, init, gn_iters=10, cg_iters=64)
        staged = rotation_init.solve_two_stage(g, init, gn_iters=10, cg_iters=64)
        chi_plain = float(plain.chi2_history[-1])
        chi_staged = float(staged.chi2_history[-1])
        assert chi_staged < 1.0, f"two-stage must reach the optimum: {chi_staged}"
        assert chi_staged <= chi_plain * 0.5 or chi_plain < 1.0

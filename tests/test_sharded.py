"""Multi-device tests on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from scl_slam.geometry import se3, so3
from scl_slam.graph import factors as F
from scl_slam.graph import solver
from scl_slam.parallel import sharded

from test_graph import (
    TIGHT_PRIOR,
    circle_trajectory,
    integrate_odometry,
    noisy_odometry_graph,
    pad_poses,
)


@pytest.fixture()
def mesh(mesh8):
    return mesh8


class TestShardedTopk:
    def test_matches_dense(self, mesh):
        key = jax.random.PRNGKey(0)
        n, d, k = 512, 20, 8
        db = jax.random.normal(key, (n, d))
        q = jax.random.normal(jax.random.fold_in(key, 1), (d,))
        mask = jnp.arange(n) < 400
        d2s, poss = sharded.sharded_topk(mesh, "shard", db, q, mask, k)
        # dense reference
        dd = jnp.sum((db - q) ** 2, axis=-1)
        dd = jnp.where(mask, dd, jnp.inf)
        ref_d2, ref_pos = jax.lax.top_k(-dd, k)
        np.testing.assert_allclose(np.asarray(d2s), np.asarray(-ref_d2), rtol=1e-5)
        np.testing.assert_array_equal(np.sort(np.asarray(poss)), np.sort(np.asarray(ref_pos)))


class TestShardedSolve:
    def test_matches_single_device(self, mesh):
        n, cap = 24, 64
        gt = circle_trajectory(n)
        g = noisy_odometry_graph(gt, jax.random.PRNGKey(0), cap=cap)
        z = se3.between(se3.index(gt, n - 1), se3.index(gt, 0))
        g = F.add_between(g, n - 1, 0, z, [1.0 / 0.01] * 6)
        init = pad_poses(integrate_odometry(g, n, se3.index(gt, 0)), cap)

        res_single = solver.solve(g, init, gn_iters=6, cg_iters=48)
        poses_sh, chis = sharded.sharded_solve(
            mesh, "shard", g, init, gn_iters=6, cg_iters=48
        )
        # same optimum (both should reach the same chi2 and nearby poses)
        chi_single = float(res_single.chi2_history[-1])
        chi_shard = float(chis[-1])
        assert abs(chi_shard - chi_single) < 0.05 * max(chi_single, 1.0)
        np.testing.assert_allclose(
            np.asarray(poses_sh.t[:n]),
            np.asarray(res_single.poses.t[:n]),
            atol=0.05,
        )

    def test_loop_correction_under_sharding(self, mesh):
        n, cap = 32, 64
        gt = circle_trajectory(n)
        g = noisy_odometry_graph(
            gt, jax.random.PRNGKey(1), sigma_rot=0.02, sigma_trans=0.1, cap=cap
        )
        for (a, b) in [(n - 1, 0), (n // 2, 0)]:
            z = se3.between(se3.index(gt, a), se3.index(gt, b))
            g = F.add_between(g, a, b, z, [1.0 / 0.001] * 6)
        init = pad_poses(integrate_odometry(g, n, se3.index(gt, 0)), cap)
        poses_sh, chis = sharded.sharded_solve(
            mesh, "shard", g, init, gn_iters=8, cg_iters=64
        )
        err = np.asarray(jnp.linalg.norm(poses_sh.t[:n] - gt.t, axis=-1))
        assert err.mean() < 0.5
        assert np.all(np.isfinite(np.asarray(chis)))


class TestShardedCoarseLevel:
    """The dense Galerkin coarsest level (shared with graph.solver via
    make_dense_coarse, psum-assembled across edge shards) must give the
    sharded solver the same long-range convergence the single-device
    solver has: block-Jacobi CG alone needs O(N) iterations to carry a
    correction across an N-pose chain."""

    def test_coarse_midscale_matches_single_device(self, mesh):
        """Mirror of test_solver_scale's midscale case through the SHARDED
        path: 512-pose circle with loops at 4096 capacity; the auto coarse
        hierarchy must (a) track the single-device solver's result and
        (b) beat block-Jacobi-only at the same budget. (Pointwise recovery
        of arbitrarily long smooth errors is NOT asserted anywhere on the
        f32 PCG paths — docs/solver_scaling.md documents that wall.)"""
        n, cap = 512, 4096
        gt = circle_trajectory(n, radius=80.0)
        g = noisy_odometry_graph(
            gt, jax.random.PRNGKey(2), sigma_rot=0.002, sigma_trans=0.02,
            cap=cap,
        )
        for (a, b) in [(n - 1, 0), (n // 2, 0), (3 * n // 4, n // 4)]:
            z = se3.between(se3.index(gt, a), se3.index(gt, b))
            g = F.add_between(g, a, b, z, [1.0 / 0.01] * 6)
        init = pad_poses(integrate_odometry(g, n, se3.index(gt, 0)), cap)
        err0 = np.asarray(jnp.linalg.norm(init.t[:n] - gt.t, axis=-1)).mean()

        res_single = solver.solve(
            g, init, gn_iters=8, cg_iters=96, coarse_stride=-1
        )
        poses_c, chis_c = sharded.sharded_solve(
            mesh, "shard", g, init, gn_iters=8, cg_iters=96,
            coarse_stride=-1,
        )
        poses_bj, chis_bj = sharded.sharded_solve(
            mesh, "shard", g, init, gn_iters=8, cg_iters=96,
            coarse_stride=0,
        )
        err_c = np.asarray(
            jnp.linalg.norm(poses_c.t[:n] - gt.t, axis=-1)
        ).mean()
        assert np.isfinite(np.asarray(chis_c)).all()
        assert err_c < 0.5 * err0
        # tracks the single-device hierarchy's answer
        chi_single = float(res_single.chi2_history[-1])
        assert float(chis_c[-1]) < 3.0 * max(chi_single, 1e-3)
        # and the coarse level is what does it
        assert float(chis_c[-1]) < 0.3 * float(chis_bj[-1]), (
            float(chis_c[-1]), float(chis_bj[-1])
        )

    def test_low_occupancy_auto_hierarchy_finite(self, mesh):
        """The fleet-drain shape (8192-slot capacity, a few dozen active
        poses in two robot blocks) through the SHARDED path: same f32
        coarse-Cholesky regression the single-device solver hit
        (tests/test_graph.py::TestLowOccupancyAutoHierarchy)."""
        cap, block = 8192, 4096
        n0, n1 = 48, 33
        gt0 = circle_trajectory(n0, radius=70.0)
        gt1 = circle_trajectory(n1, radius=70.0)
        g = F.make_graph(edge_capacity=8192, prior_capacity=8)
        g = F.add_prior(g, 0, se3.index(gt0, 0), [10.0] * 6)
        g = F.add_prior(g, block, se3.index(gt1, 0), [10.0] * 3 + [1e-4] * 3)
        for i in range(n0 - 1):
            z = se3.between(se3.index(gt0, i), se3.index(gt0, i + 1))
            g = F.add_between(g, i, i + 1, z, [200.0] * 6)
        for i in range(n1 - 1):
            z = se3.between(se3.index(gt1, i), se3.index(gt1, i + 1))
            g = F.add_between(g, block + i, block + i + 1, z, [200.0] * 6)
        z = se3.between(se3.index(gt0, 0), se3.index(gt1, 32 % n1))
        g = F.add_between(g, 0, block + 32 % n1, z, [1.4] * 6)
        init = se3.identity((cap,))
        init = se3.Pose(
            init.R.at[:n0].set(gt0.R).at[block : block + n1].set(gt1.R),
            init.t.at[:n0].set(gt0.t).at[block : block + n1].set(gt1.t),
        )
        poses, chis = sharded.sharded_solve(
            mesh, "shard", g, init, gn_iters=3, cg_iters=16,
        )
        assert np.isfinite(np.asarray(chis)).all()
        assert np.isfinite(np.asarray(poses.t)).all()

"""Long-trajectory solver behavior: what is (and is not) achievable at scale.

Round-2 findings this file pins (full writeup: docs/solver_scaling.md):

- An N-pose chain's smooth modes have relative eigenvalues ~(pi/2N)^2.
  Below N ~ 5k they sit above f32 matvec noise and iterative solves work;
  beyond that NO f32 Krylov method — any preconditioner — can place the
  solution along them (measured: a 4 m kink at 32k poses survived 512
  multilevel-PCG iterations).
- The exact chain+loops direct solver (graph/chain_solver.py: gauge-
  invariant increment basis + Woodbury) solves the same problem to
  centimeters in TWO Gauss-Newton steps in f64; in f32 its capacitance
  matrix (the prior marginal covariance of loop gaps, dynamic range ~N^3
  from yaw-lever^2 terms) limits it to modest scales/weights.
- The AUTO multilevel preconditioner (coarse_stride = -1, the config
  default) picks the hierarchy from pose count so nothing needs
  hand-tuning at any capacity, and keeps mid-scale (<= ~4k poses — the
  KITTI-00 regime) loop corrections converging.
"""
import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3
from scl_slam.graph import factors as F
from scl_slam.graph import solver
from scl_slam.graph.chain_solver import chain_solve

from test_graph import (
    circle_trajectory,
    integrate_odometry,
    noisy_odometry_graph,
    pad_poses,
)


def straight_chain(n, w_odom=1e2, w_prior=1e3, dtype=jnp.float32):
    """Straight unit-x chain with exact measurements + anchored start."""
    gt_t = jnp.stack(
        [jnp.arange(n, dtype=dtype), jnp.zeros(n, dtype), jnp.zeros(n, dtype)],
        axis=-1,
    )
    gt = se3.Pose(jnp.broadcast_to(jnp.eye(3, dtype=dtype), (n, 3, 3)), gt_t)
    g = F.make_graph(n + 8, 4)
    if dtype == jnp.float64:
        g = jax.tree_util.tree_map(
            lambda a: a.astype(dtype) if a.dtype == jnp.float32 else a, g
        )
    g = F.add_prior(g, 0, se3.index(gt, 0), [w_prior] * 6)
    z = se3.Pose(
        jnp.broadcast_to(jnp.eye(3, dtype=dtype), (n - 1, 3, 3)),
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], dtype), (n - 1, 3)),
    )
    g = F.add_between_block(g, jnp.arange(n - 1), jnp.arange(1, n), z, [w_odom] * 6)
    for (a, b) in [(0, n - 1), (0, n // 2), (n // 4, 3 * n // 4)]:
        zl = se3.between(se3.index(gt, a), se3.index(gt, b))
        g = F.add_between(g, a, b, zl, [w_odom] * 6)
    return g, gt


class TestAutoCoarse:
    def test_rule(self):
        assert solver.auto_coarse(128) == (0, 1)
        assert solver.auto_coarse(2048) == (0, 1)
        assert solver.auto_coarse(4096) == (16, 1)       # C = 256
        assert solver.auto_coarse(32768) == (16, 2)      # C = 128
        assert solver.auto_coarse(131072) == (16, 3)     # C = 32
        assert solver.auto_coarse(1 << 20) == (16, 3)    # C = 256
        # dense coarsest stays inside the int32 flat-index assembly bound
        for n in (4096, 32768, 131072, 1 << 20):
            s, l = solver.auto_coarse(n)
            C = -(-n // s**l)
            assert C * 6 <= 7723

    def test_auto_is_default_and_solves_midscale(self):
        """512-pose circle with loops at 4096 capacity through
        coarse_stride=-1 (the config default triggers the auto hierarchy):
        the mid-scale regime the drain actually runs at."""
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
        err0 = np.asarray(
            jnp.linalg.norm(init.t[:n] - gt.t, axis=-1)
        ).mean()
        res = solver.solve(g, init, gn_iters=8, cg_iters=96, coarse_stride=-1)
        err = np.asarray(
            jnp.linalg.norm(res.poses.t[:n] - gt.t, axis=-1)
        ).mean()
        assert np.all(np.isfinite(np.asarray(res.chi2_history)))
        assert float(res.chi2_history[-1]) < 0.01 * float(res.chi2_history[0])
        assert err < 0.5 * err0
        # ... and the hierarchy is what does it: block-Jacobi alone leaves
        # an order of magnitude more residual energy at the same budget
        res_bj = solver.solve(g, init, gn_iters=8, cg_iters=96, coarse_stride=0)
        assert float(res.chi2_history[-1]) < 0.3 * float(res_bj.chi2_history[-1])


class TestChainSolver:
    def test_matches_pcg_on_circle(self):
        """Small-scale f32: the direct solver and PCG land on the same
        optimum (both are Newton; chain is exact, PCG converges here)."""
        n, cap = 24, 64
        gt = circle_trajectory(n)
        g = noisy_odometry_graph(gt, jax.random.PRNGKey(0), cap=cap)
        z = se3.between(se3.index(gt, n - 1), se3.index(gt, 0))
        g = F.add_between(g, n - 1, 0, z, [1.0 / 0.01] * 6)
        init = pad_poses(integrate_odometry(g, n, se3.index(gt, 0)), cap)
        res_pcg = solver.solve(g, init, gn_iters=6, cg_iters=64)
        res_ch = chain_solve(g, init, gn_iters=6, loop_capacity=16)
        assert not bool(res_ch.loop_overflow)
        assert abs(
            float(res_ch.chi2_history[-1]) - float(res_pcg.chi2_history[-1])
        ) < 0.05 * max(float(res_pcg.chi2_history[-1]), 1.0)
        np.testing.assert_allclose(
            np.asarray(res_ch.poses.t[:n]),
            np.asarray(res_pcg.poses.t[:n]),
            atol=1e-3,
        )

    def test_32k_exact_in_f64(self):
        """THE 32k-pose regression: a 4 m mid-chain kink with loop factors
        resolves in TWO GN steps through the direct solver (f64 — the
        regime where its capacitance is well-posed). No f32 iterative
        method achieves this (see module doc).

        Accuracy is asserted on what the DATA determines: the kink energy
        (6.4e5 -> ~2), the kink discontinuity itself, and every
        loop-anchored pose (sub-mm). Between anchors the chain has
        near-unobservable "bow" modes (a 1.7 m arc over 8k poses costs
        chi ~3e-6 — posterior sigma is meters there), so a pointwise
        maxerr bound would test the prior, not the solver."""
        with jax.enable_x64(True):
            n = 32768
            g, gt = straight_chain(n, dtype=jnp.float64)
            init = se3.Pose(gt.R, gt.t.at[n // 2 :, 1].add(4.0))
            res = chain_solve(g, init, gn_iters=2, loop_capacity=16)
            y = np.asarray(res.poses.t[:n, 1])
            assert not bool(res.loop_overflow)
            assert float(res.chi2_history[-1]) < 50.0
            assert abs(y[n // 2] - y[n // 2 - 1]) < 1e-2   # kink removed
            for k in (0, n // 2, n - 1):                   # loop anchors
                assert abs(y[k]) < 0.01
            assert abs(y[3 * n // 4]) < 0.2

    def test_overflow_flag(self):
        n = 64
        g, gt = straight_chain(n)
        init = se3.Pose(gt.R, gt.t)
        res = chain_solve(g, init, gn_iters=1, loop_capacity=2)  # 3 loops
        assert bool(res.loop_overflow)


class Test32kF32Envelope:
    def test_pcg_auto_is_finite_and_reduces_kink_energy(self):
        """The f32 PCG path at 32k: resolves the kink's energy (chi drops
        4+ orders) but CANNOT place the far end — the smooth modes sit
        below f32 arithmetic noise. This test pins the honest envelope;
        if it ever starts passing a tight maxerr bound, tighten it and
        update docs/solver_scaling.md."""
        n = 32768
        g, gt = straight_chain(n)
        init = se3.Pose(gt.R, gt.t.at[n // 2 :, 1].add(4.0))
        chi0 = float(F.chi2(g, init))
        res = solver.solve(g, init, gn_iters=2, cg_iters=24, coarse_stride=-1)
        assert np.all(np.isfinite(np.asarray(res.chi2_history)))
        assert float(res.chi2_history[-1]) < 2e-3 * chi0

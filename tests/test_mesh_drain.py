"""Mesh-attached live drain: the distributed two-stage solve in the pipeline.

The reference's PRODUCTION optimizer path is ``distributedOptimizer`` —
two-stage rotation-then-pose distributed solve (reference
``include/distributedMapping.h:878-880``) with gamma over-relaxation and
rotThres/poseThres early stop (``:525-535``). These tests run that path
through the actual ``Mapper`` runtime on the virtual 8-device mesh and check
it against the single-device drain and ground truth.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scl_slam.config import (
    KeyframeConfig,
    LoopConfig,
    OptimizerConfig,
    ScanContextParams,
    SlamConfig,
)
from scl_slam.geometry import se3, so3
from scl_slam.runtime import Mapper
from scl_slam.runtime.mapper import _queue_loop, encode_kf

from test_graph import circle_trajectory


N = 24  # keyframes around the loop


def drain_cfg(**opt_kw):
    opt = dict(
        edge_capacity=128,       # divisible by the 8-device mesh axis
        gn_iters=8,
        cg_iters=48,
        max_outer_rounds=8,
        # anchor the gauge tightly: absolute-error assertions below
        prior_sigmas=(1e-3,) * 6,
    )
    opt.update(opt_kw)
    return SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=32,            # 32 slots: divisible by 8
            points_per_keyframe=512,
            raw_points_capacity=1024,
            distance_threshold=0.5,
        ),
        loop=LoopConfig(intra_enabled=False, inter_enabled=False),
        optimizer=OptimizerConfig(**opt),
        scan_context=ScanContextParams(exclude_recent=2, num_candidates=4),
    )


def drifting_circle(n, yaw_drift=0.02, trans_drift=0.05):
    """(gt, odom) pose lists: odometry accumulates per-frame twist drift."""
    gt = circle_trajectory(n)
    drift = se3.Pose(
        so3.from_euler(jnp.array([0.0, 0.0, yaw_drift])),
        jnp.array([trans_drift, 0.0, 0.0]),
    )
    odom = [se3.index(gt, 0)]
    for k in range(1, n):
        inc = se3.between(se3.index(gt, k - 1), se3.index(gt, k))
        odom.append(se3.compose(odom[-1], se3.compose(inc, drift)))
    return gt, odom


def build_mapper(cfg, odom, seed=0):
    """Ingest the odometry chain with small random scans (detection off)."""
    rng = np.random.RandomState(seed)
    m = Mapper(cfg)
    for k, pose in enumerate(odom):
        scan = rng.uniform(-20, 20, (1024, 3)).astype(np.float32)
        m.add_frame(pose, scan, stamp=0.1 * k)
    assert m._keyframes == len(odom)
    return m


def inject_gt_loops(m, gt, pairs, noise=1e-3):
    """Queue ground-truth loop factors (the post-verification product)."""
    for (i, j) in pairs:
        z = se3.between(se3.index(gt, i), se3.index(gt, j))
        m.state = _queue_loop(
            m.state,
            jnp.array(encode_kf(0, i)),
            jnp.array(encode_kf(0, j)),
            z,
            jnp.array(noise, jnp.float32),
            m.cfg,
        )


def ate(m, gt):
    est = m.trajectory()
    return float(
        np.sqrt(
            np.mean(
                np.sum((est[:, :3, 3] - np.asarray(gt.t[: len(est)])) ** 2, -1)
            )
        )
    )


class TestMeshDrain:
    def test_two_stage_matches_single_device_drain(self, mesh8):
        """Same state drained via both paths -> same corrected trajectory."""
        cfg = drain_cfg()
        gt, odom = drifting_circle(N)
        m1 = build_mapper(cfg, odom)
        inject_gt_loops(m1, gt, [(0, N - 1), (0, N // 2)])

        m2 = Mapper(cfg)
        m2.state = jax.tree_util.tree_map(lambda a: a, m1.state)
        m2._keyframes = m1._keyframes
        m2.attach_mesh(mesh8)

        ate_before = ate(m1, gt)
        chi_single = m1.optimize()
        chi_mesh = m2.optimize()

        # both paths actually solved (loop factors were added)
        assert np.all(np.isfinite(chi_single)) and np.all(np.isfinite(chi_mesh))
        assert int(m1.state.loop_queue.count) == 0
        assert int(m2.state.loop_queue.count) == 0
        a1, a2 = ate(m1, gt), ate(m2, gt)
        assert a1 < 0.5 * ate_before
        assert a2 < 0.5 * ate_before
        # same optimum through either path
        np.testing.assert_allclose(
            m1.trajectory()[:, :3, 3], m2.trajectory()[:, :3, 3], atol=0.05
        )

    def test_large_rotation_converges_through_rotation_stage(self, mesh8):
        """Severe accumulated yaw drift (the regime chordal init exists for):
        the two-stage mesh drain still recovers the circle."""
        # odometry is severely biased here (the injected drift), so its
        # factors must be weighted honestly loose or the MAP optimum sits
        # near the drifted chain instead of the loop-consistent circle
        cfg = drain_cfg(
            max_outer_rounds=10,
            odometry_sigmas=(0.1, 0.1, 0.1, 0.2, 0.2, 0.2),
        )
        gt, odom = drifting_circle(N, yaw_drift=0.12, trans_drift=0.1)
        m = build_mapper(cfg, odom)
        inject_gt_loops(
            m, gt, [(0, N - 1), (0, N // 2), (N // 4, 3 * N // 4)]
        )
        m.attach_mesh(mesh8)
        ate_before = ate(m, gt)
        assert ate_before > 2.0  # the drift is severe
        m.optimize()
        assert ate(m, gt) < 0.25 * ate_before

    def test_change_threshold_freezes_iteration(self, mesh8):
        """Huge rotThres/poseThres: the solve freezes after one GN step —
        chi2 history is constant from iteration 2 on (the early-stop
        contract, reference distributedMapping.h:530-531)."""
        cfg = drain_cfg(
            rotation_change_threshold=1e6, pose_change_threshold=1e6
        )
        gt, odom = drifting_circle(N)
        m = build_mapper(cfg, odom)
        inject_gt_loops(m, gt, [(0, N - 1)])
        m.attach_mesh(mesh8)
        chis = m.optimize()
        assert len(chis) == cfg.optimizer.max_outer_rounds
        # chis[k] is evaluated at the linearization point of step k; frozen
        # steps relinearize at the same (post-step-1) poses
        np.testing.assert_allclose(chis[1:], chis[1], rtol=1e-5)

    def test_gamma_zero_is_identity(self, mesh8):
        """gamma=0 nullifies every update (over-relaxation wiring check)."""
        cfg = drain_cfg(gamma=0.0)
        gt, odom = drifting_circle(N)
        m = build_mapper(cfg, odom)
        before = m.trajectory()
        inject_gt_loops(m, gt, [(0, N - 1)])
        m.attach_mesh(mesh8)
        m.optimize()
        # rotation stage still runs (gamma gates only the GN update), so
        # compare translations, which chordal init leaves untouched
        np.testing.assert_allclose(
            m.trajectory()[:, :3, 3], before[:, :3, 3], atol=1e-5
        )

    def test_detach_restores_single_device_path(self, mesh8):
        cfg = drain_cfg()
        gt, odom = drifting_circle(N)
        m = build_mapper(cfg, odom)
        m.attach_mesh(mesh8)
        m.detach_mesh()
        inject_gt_loops(m, gt, [(0, N - 1)])
        chis = m.optimize()
        # single-device drain returns gn_iters + 1 entries (incl. chi2_0)
        assert len(chis) == cfg.optimizer.gn_iters + 1

    def test_attach_rejects_indivisible_capacity(self, mesh8):
        cfg = drain_cfg(edge_capacity=100)
        m = Mapper(cfg)
        with pytest.raises(ValueError):
            m.attach_mesh(mesh8)

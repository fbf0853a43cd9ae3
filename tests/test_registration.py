import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3, so3
from scl_slam.ops import pointcloud as pc
from scl_slam.ops import registration as reg


def random_cloud(key, n, capacity, scale=10.0):
    pts = jax.random.uniform(key, (n, 3), minval=-scale, maxval=scale)
    return pc.from_points(np.asarray(pts), capacity)


def known_transform(dtheta=0.15, dt=(0.5, -0.3, 0.2)):
    R = so3.exp(jnp.array([0.02, -0.03, dtheta]))
    return se3.Pose(R, jnp.array(dt))


class TestKabsch:
    def test_exact_recovery(self):
        key = jax.random.PRNGKey(0)
        src = jax.random.normal(key, (100, 3)) * 5
        gt = known_transform()
        dst = se3.transform_points(gt, src)
        est = reg.kabsch(src, dst, jnp.ones(100))
        np.testing.assert_allclose(np.asarray(est.R), np.asarray(gt.R), atol=1e-5)
        np.testing.assert_allclose(np.asarray(est.t), np.asarray(gt.t), atol=1e-4)

    def test_weighted_ignores_outliers(self):
        key = jax.random.PRNGKey(1)
        src = jax.random.normal(key, (100, 3)) * 5
        gt = known_transform()
        dst = se3.transform_points(gt, src)
        # corrupt last 20 correspondences, weight them 0
        dst = dst.at[80:].add(100.0)
        w = jnp.concatenate([jnp.ones(80), jnp.zeros(20)])
        est = reg.kabsch(src, dst, w)
        np.testing.assert_allclose(np.asarray(est.R), np.asarray(gt.R), atol=1e-5)

    def test_batched(self):
        key = jax.random.PRNGKey(2)
        src = jax.random.normal(key, (4, 50, 3))
        gt_R = so3.exp(jax.random.normal(jax.random.fold_in(key, 1), (4, 3)) * 0.3)
        gt_t = jax.random.normal(jax.random.fold_in(key, 2), (4, 3))
        dst = jnp.einsum("bij,bnj->bni", gt_R, src) + gt_t[:, None]
        est = reg.kabsch(src, dst, jnp.ones((4, 50)))
        np.testing.assert_allclose(np.asarray(est.R), np.asarray(gt_R), atol=1e-4)


class TestNearestNeighbors:
    def test_exact(self):
        key = jax.random.PRNGKey(3)
        target = jax.random.normal(key, (256, 3)) * 10
        query = target[7:20] + 0.01
        d2, idx = reg.nearest_neighbors(query, target)
        np.testing.assert_array_equal(np.asarray(idx), np.arange(7, 20))
        assert np.all(np.asarray(d2) < 0.001)


class TestICP:
    def test_recovers_small_transform(self):
        key = jax.random.PRNGKey(4)
        target = random_cloud(key, 800, 1024, scale=20.0)
        gt = known_transform(dtheta=0.1, dt=(0.8, -0.5, 0.1))
        # source = inverse-transformed target points (so gt maps src -> tgt)
        inv = se3.inverse(gt)
        src_pts = se3.transform_points(inv, target.xyz[:800])
        source = pc.Cloud(
            jnp.where(jnp.arange(1024)[:, None] < 800,
                      jnp.pad(src_pts, ((0, 224), (0, 0)), constant_values=pc.PAD_VALUE),
                      pc.PAD_VALUE),
            jnp.arange(1024) < 800,
        )
        result = reg.icp(source, target, max_iters=25, max_corr_dist=5.0)
        np.testing.assert_allclose(np.asarray(result.pose.R), np.asarray(gt.R), atol=1e-3)
        np.testing.assert_allclose(np.asarray(result.pose.t), np.asarray(gt.t), atol=1e-2)
        assert float(result.fitness) < 1e-4

    def test_fitness_high_for_unrelated(self):
        k1, k2 = jax.random.split(jax.random.PRNGKey(5))
        a = random_cloud(k1, 500, 512, scale=20.0)
        b_pts = np.asarray(jax.random.uniform(k2, (500, 3), minval=100, maxval=140))
        b = pc.from_points(b_pts, 512)
        result = reg.icp(a, b, max_iters=10, max_corr_dist=5.0)
        # no correspondences within range -> inlier_frac ~ 0
        assert float(result.inlier_frac) < 0.05


class TestRansac:
    def test_accepts_true_overlap(self):
        # NN correspondences presuppose drift-scale misalignment: the
        # reference transforms both clouds into the map frame before
        # verification (distributedMapping.h:1325-1338), so only residual
        # drift separates them
        key = jax.random.PRNGKey(6)
        target = random_cloud(key, 800, 1024, scale=20.0)
        gt = known_transform(dtheta=0.05, dt=(0.5, 0.3, 0.1))
        src_pts = se3.transform_points(se3.inverse(gt), target.xyz[:800])
        # add 20% outlier points
        noise = jax.random.uniform(
            jax.random.fold_in(key, 1), (200, 3), minval=-30, maxval=30
        )
        src_all = jnp.concatenate([src_pts[:600], noise], axis=0)
        source = pc.from_points(np.asarray(src_all), 1024)
        res = reg.ransac_align(
            source, target, jax.random.PRNGKey(7),
            num_hypotheses=256, inlier_thresh=0.3, min_inlier_ratio=0.45,
        )
        assert bool(res.success)
        np.testing.assert_allclose(np.asarray(res.pose.R), np.asarray(gt.R), atol=5e-3)
        np.testing.assert_allclose(np.asarray(res.pose.t), np.asarray(gt.t), atol=0.1)

    def test_rejects_unrelated(self):
        k1, k2 = jax.random.split(jax.random.PRNGKey(8))
        a = random_cloud(k1, 400, 512, scale=20.0)
        b = random_cloud(k2, 400, 512, scale=20.0)
        res = reg.ransac_align(
            a, b, jax.random.PRNGKey(9),
            num_hypotheses=128, inlier_thresh=0.25, min_inlier_ratio=0.45,
        )
        assert not bool(res.success)

    def test_jittable(self):
        key = jax.random.PRNGKey(10)
        target = random_cloud(key, 300, 512)
        source = random_cloud(jax.random.fold_in(key, 1), 300, 512)
        f = jax.jit(
            lambda s, t, k: reg.ransac_align(s, t, k, num_hypotheses=64)
        )
        out = f(source, target, jax.random.PRNGKey(11))
        assert np.isfinite(float(out.inlier_ratio))


class TestRansacBatched:
    """Lane-batched RANSAC (the fleet inter-verification path) must match
    solo runs per lane: recover true transforms on overlap lanes, reject
    unrelated lanes, and return inert results for inactive lanes."""

    def _mixed_lanes(self):
        key = jax.random.PRNGKey(20)
        gts, sources, targets = [], [], []
        # lane 0: true overlap; lane 1: unrelated junk; lane 2: true
        # overlap but INACTIVE
        for i, related in enumerate((True, False, True)):
            k = jax.random.fold_in(key, i)
            tgt = random_cloud(k, 800, 1024, scale=20.0)
            gt = known_transform(dtheta=0.05 + 0.02 * i, dt=(0.5, 0.3, 0.1))
            if related:
                src_pts = se3.transform_points(se3.inverse(gt), tgt.xyz[:800])
                src = pc.from_points(np.asarray(src_pts), 1024)
            else:
                src = random_cloud(jax.random.fold_in(k, 99), 800, 1024,
                                   scale=20.0)
            gts.append(gt)
            sources.append(src)
            targets.append(tgt)
        stack = lambda cs: pc.Cloud(
            jnp.stack([c.xyz for c in cs]), jnp.stack([c.mask for c in cs])
        )
        return gts, stack(sources), stack(targets)

    def test_mixed_lanes(self):
        gts, sources, targets = self._mixed_lanes()
        active = jnp.array([True, True, False])
        res = reg.ransac_align_batched(
            sources, targets, jax.random.PRNGKey(21), active,
            num_hypotheses=256, inlier_thresh=0.3, min_inlier_ratio=0.45,
        )
        ok = np.asarray(res.success)
        assert ok[0] and not ok[1] and not ok[2]
        np.testing.assert_allclose(
            np.asarray(res.pose.R[0]), np.asarray(gts[0].R), atol=5e-3
        )
        np.testing.assert_allclose(
            np.asarray(res.pose.t[0]), np.asarray(gts[0].t), atol=0.1
        )
        # inactive lane: identity pose, zero ratio
        np.testing.assert_allclose(
            np.asarray(res.pose.R[2]), np.eye(3), atol=1e-6
        )
        assert float(res.inlier_ratio[2]) == 0.0

    def test_matches_solo_quality(self):
        """Each active batched lane must reach the solo path's accept
        decision on the same inputs (sampling RNG differs, so poses are
        compared to ground truth, not bitwise)."""
        gts, sources, targets = self._mixed_lanes()
        active = jnp.ones(3, bool)
        res_b = reg.ransac_align_batched(
            sources, targets, jax.random.PRNGKey(22), active,
            num_hypotheses=256, inlier_thresh=0.3, min_inlier_ratio=0.45,
        )
        for lane in range(3):
            solo = reg.ransac_align(
                pc.Cloud(sources.xyz[lane], sources.mask[lane]),
                pc.Cloud(targets.xyz[lane], targets.mask[lane]),
                jax.random.PRNGKey(23 + lane),
                num_hypotheses=256, inlier_thresh=0.3, min_inlier_ratio=0.45,
            )
            assert bool(res_b.success[lane]) == bool(solo.success)
            if bool(solo.success):
                np.testing.assert_allclose(
                    np.asarray(res_b.pose.R[lane]),
                    np.asarray(solo.pose.R), atol=1e-2,
                )

    def test_collapsed_false_match_rejected(self):
        """Regression: on a FALSE match whose clouds barely overlap, the NN
        correspondences collapse many-to-one onto the target boundary; a
        degenerate (coincident-dst) minimal sample then yields a rank-0
        'transform' that scores the whole collapse cluster as inliers —
        accepted at ratio 0.52 with a ZERO rotation before the
        triangles_ok sample-rejection gate (NaN poses downstream)."""
        key = jax.random.PRNGKey(30)
        # target: dense cluster near origin; source: far-away sheet whose
        # nearest target is always the cluster boundary
        tgt_pts = jax.random.uniform(key, (800, 3), minval=0.0, maxval=5.0)
        src_pts = jax.random.uniform(
            jax.random.fold_in(key, 1), (800, 3), minval=0.0, maxval=5.0
        ) + jnp.array([80.0, 0.0, 0.0])
        target = pc.from_points(np.asarray(tgt_pts), 1024)
        source = pc.from_points(np.asarray(src_pts), 1024)
        solo = reg.ransac_align(
            source, target, jax.random.PRNGKey(31),
            num_hypotheses=256, inlier_thresh=0.3, min_inlier_ratio=0.45,
        )
        assert not bool(solo.success), float(solo.inlier_ratio)
        batched = reg.ransac_align_batched(
            pc.Cloud(source.xyz[None], source.mask[None]),
            pc.Cloud(target.xyz[None], target.mask[None]),
            jax.random.PRNGKey(31), jnp.array([True]),
            num_hypotheses=256, inlier_thresh=0.3, min_inlier_ratio=0.45,
        )
        assert not bool(batched.success[0]), float(batched.inlier_ratio[0])
        # results stay finite and well-formed for downstream factor math
        for R in (solo.pose.R, batched.pose.R[0]):
            assert np.isfinite(np.asarray(R)).all()
            assert abs(np.linalg.det(np.asarray(R))) > 0.5  # not rank-deficient

    def test_hypothesis_chunking_invariant(self):
        gts, sources, targets = self._mixed_lanes()
        active = jnp.ones(3, bool)
        kw = dict(num_hypotheses=128, inlier_thresh=0.3,
                  min_inlier_ratio=0.45)
        a = reg.ransac_align_batched(
            sources, targets, jax.random.PRNGKey(24), active,
            hyp_chunk=32, **kw,
        )
        b = reg.ransac_align_batched(
            sources, targets, jax.random.PRNGKey(24), active,
            hyp_chunk=128, **kw,
        )
        np.testing.assert_allclose(
            np.asarray(a.pose.R), np.asarray(b.pose.R), atol=1e-6
        )
        np.testing.assert_array_equal(
            np.asarray(a.num_inliers), np.asarray(b.num_inliers)
        )


class TestHopelessLaneExit:
    """gate_fitness enables an early freeze ONLY for lanes that are both
    stalled and >= HOPELESS_MARGIN x above the accept gate — it must never
    change the outcome of a lane that ends anywhere near the gate."""

    def _true_pair(self, key, scale=20.0):
        target = random_cloud(key, 800, 1024, scale=scale)
        gt = known_transform(dtheta=0.1, dt=(0.8, -0.5, 0.1))
        src_pts = se3.transform_points(se3.inverse(gt), target.xyz[:800])
        source = pc.from_points(np.asarray(src_pts), 1024)
        return source, target, gt

    def test_gated_matches_ungated_on_true_loop(self):
        source, target, gt = self._true_pair(jax.random.PRNGKey(20))
        base = reg.icp(source, target, max_iters=25, max_corr_dist=5.0,
                       tol=1e-4)
        gated = reg.icp(source, target, max_iters=25, max_corr_dist=5.0,
                        tol=1e-4, gate_fitness=0.3)
        # a converging true loop is never near the hopeless region: results
        # must be bitwise identical (the exit condition is simply false)
        np.testing.assert_array_equal(np.asarray(base.pose.R),
                                      np.asarray(gated.pose.R))
        np.testing.assert_array_equal(np.asarray(base.pose.t),
                                      np.asarray(gated.pose.t))
        assert float(gated.fitness) < 0.3

    def test_junk_lane_still_fails_gate(self):
        k1, k2 = jax.random.split(jax.random.PRNGKey(21))
        a = random_cloud(k1, 500, 512, scale=20.0)
        b_pts = np.asarray(
            jax.random.uniform(k2, (500, 3), minval=25, maxval=65)
        )
        b = pc.from_points(b_pts, 512)
        gated = reg.icp(a, b, max_iters=30, max_corr_dist=10.0,
                        tol=1e-4, gate_fitness=0.3)
        # random non-overlapping geometry stalls far above the gate; the
        # hopeless exit freezes it WITHOUT flipping the reject decision
        assert float(gated.fitness) > 0.3

    def test_batched_mixed_lanes(self):
        source, target, gt = self._true_pair(jax.random.PRNGKey(22))
        k1, k2 = jax.random.split(jax.random.PRNGKey(23))
        junk_src = random_cloud(k1, 500, 1024, scale=20.0)
        junk_tgt_pts = np.asarray(
            jax.random.uniform(k2, (500, 3), minval=25, maxval=65)
        )
        junk_tgt = pc.from_points(junk_tgt_pts, 1024)

        stack = lambda *xs: jax.tree.map(
            lambda *ls: jnp.stack(ls), *xs
        )
        src_b = stack(source, junk_src)
        tgt_b = stack(target, junk_tgt)
        res = reg.icp_batched(
            src_b, tgt_b, se3.identity((2,)), jnp.array([True, True]),
            max_iters=25, max_corr_dist=5.0, tol=1e-4,
            gate_fitness=0.3,
        )
        solo = reg.icp(source, target, max_iters=25, max_corr_dist=5.0,
                       tol=1e-4, gate_fitness=0.3)
        # true lane converges to the solo answer; junk lane fails the gate
        np.testing.assert_allclose(np.asarray(res.pose.R[0]),
                                   np.asarray(solo.pose.R), atol=1e-5)
        np.testing.assert_allclose(np.asarray(res.pose.t[0]),
                                   np.asarray(solo.pose.t), atol=1e-4)
        assert float(res.fitness[0]) < 0.3
        assert float(res.fitness[1]) > 0.3


class TestTargetStride:
    """icp(..., target_stride=s): mid-resolution warm-start stage. On a
    well-overlapped pair the full-resolution polish must land at the same
    optimum as the exact schedule; non-divisible strides fall back."""

    def test_stride2_matches_exact_on_full_overlap(self):
        key = jax.random.PRNGKey(30)
        target = random_cloud(key, 800, 1024, scale=20.0)
        gt = known_transform(dtheta=0.1, dt=(0.8, -0.5, 0.1))
        src_pts = se3.transform_points(se3.inverse(gt), target.xyz[:800])
        source = pc.from_points(np.asarray(src_pts), 1024)
        r1 = reg.icp(source, target, max_iters=30, max_corr_dist=5.0,
                     tol=1e-5, target_stride=1)
        r2 = reg.icp(source, target, max_iters=30, max_corr_dist=5.0,
                     tol=1e-5, target_stride=2)
        np.testing.assert_allclose(np.asarray(r1.pose.t),
                                   np.asarray(r2.pose.t), atol=1e-3)
        np.testing.assert_allclose(np.asarray(r1.pose.R),
                                   np.asarray(r2.pose.R), atol=1e-4)
        assert abs(float(r1.fitness) - float(r2.fitness)) < 1e-4

    def test_non_divisible_stride_falls_back(self):
        key = jax.random.PRNGKey(31)
        target = random_cloud(key, 700, 1024, scale=20.0)
        source = random_cloud(jax.random.fold_in(key, 1), 700, 1024)
        # 1024 % 3 != 0: the mid stage must be skipped, not crash
        r = reg.icp(source, target, max_iters=5, max_corr_dist=5.0,
                    target_stride=3)
        assert np.isfinite(float(r.inlier_frac))


def test_nearest_neighbors_non_divisible_query():
    """Regression (round-3 config fuzz): a query count that the block size
    doesn't divide (e.g. points_per_keyframe=1000) crashed the tiled
    fallback's reshape. Padding must give identical results to the dense
    computation."""
    key = jax.random.PRNGKey(40)
    q = jax.random.uniform(key, (1000, 3), minval=-20, maxval=20)
    t = jax.random.uniform(jax.random.fold_in(key, 1), (700, 3),
                           minval=-20, maxval=20)
    d2, idx = reg.nearest_neighbors(q, t)
    ref = np.asarray(
        ((np.asarray(q)[:, None, :] - np.asarray(t)[None]) ** 2).sum(-1)
    )
    np.testing.assert_array_equal(np.asarray(idx), ref.argmin(1))
    # d2 comes from the expanded matmul form: f32 error ~eps * |coords|^2
    np.testing.assert_allclose(np.asarray(d2), ref.min(1), atol=1e-3)

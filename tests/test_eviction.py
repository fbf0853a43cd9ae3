"""City-scale map management: eviction + block compaction
(scl_slam/runtime/eviction.py).

The reference grows its keyframe stores without bound; here fixed-capacity
blocks compact when full. These tests check the three invariants that make
that safe: the session continues past capacity (no corruption of neighbor
blocks, protocol indices keep counting), loop anchors and their factors
survive compaction exactly, and the recomposed odometry chain is the exact
composition of the evicted increments.
"""
import jax.numpy as jnp
import numpy as np

from scl_slam.config import (
    KeyframeConfig,
    LoopConfig,
    OptimizerConfig,
    ScanContextParams,
    SlamConfig,
)
from scl_slam.geometry import se3
from scl_slam.runtime import mapper as M
from scl_slam.runtime.eviction import compact_robot, plan_keep
from scl_slam.runtime.mapper import Mapper


def small_cfg(**kw):
    kf = dict(
        max_keyframes=24,
        points_per_keyframe=256,
        raw_points_capacity=512,
        evict_keep_recent=4,
        evict_stride=2,
        distance_threshold=0.5,
    )
    kf.update(kw.pop("keyframe", {}))
    return SlamConfig(
        number_of_robots=kw.pop("number_of_robots", 1),
        keyframe=KeyframeConfig(**kf),
        loop=LoopConfig(
            near_keyframes=2, submap_capacity=512, queue_capacity=8,
            intra_enabled=False, inter_enabled=False,
        ),
        optimizer=OptimizerConfig(edge_capacity=96, gn_iters=2, cg_iters=8),
        scan_context=ScanContextParams(exclude_recent=2),
        **kw,
    )


def drive(mapper, n, start=0):
    rng = np.random.RandomState(7)
    for k in range(start, start + n):
        xyz = rng.uniform(-20, 20, (256, 3)).astype(np.float32)
        pose = se3.Pose(jnp.eye(3), jnp.array([2.0 * k, 0.0, 0.0]))
        wire = mapper.add_frame(pose, xyz, stamp=float(k))
        assert wire is not None, f"frame {k} rejected"
    return mapper


class TestEvictionPipeline:
    def test_session_continues_past_capacity(self):
        cfg = small_cfg()
        m = Mapper(cfg)
        drive(m, 60)
        K = cfg.keyframe.max_keyframes
        n = int(m.state.counts[0])
        assert n <= K, "block must never exceed capacity"
        assert len(m._evicted.get(0, [])) == 60 - n, "rest must be archived"
        assert m._keyframes == 60
        # protocol indices keep counting and stay strictly increasing
        idx = np.asarray(m.state.desc_db.index[:n])
        assert idx[-1] == 59
        assert (np.diff(idx) > 0).all()
        assert m.next_index(0) == 60
        # tail slots are cleared
        assert (np.asarray(m.state.desc_db.index[n:K]) == -1).all()
        # full trajectory covers every keyframe ever, in index order
        poses, stamps = m.full_trajectory(0)
        assert len(poses) == 60
        np.testing.assert_allclose(stamps, np.arange(60.0))
        np.testing.assert_allclose(
            poses[:, 0, 3], 2.0 * np.arange(60.0), atol=1e-3
        )

    def test_optimize_consistent_after_compaction(self):
        cfg = small_cfg()
        m = Mapper(cfg)
        drive(m, 60)
        # noise-free odometry: recomposed chain factors must be satisfied
        # exactly by the current estimates -> optimization is a no-op
        chi = m.optimize()
        assert float(chi[-1]) < 1e-3
        n = int(m.state.counts[0])
        np.testing.assert_allclose(
            np.asarray(m.state.opt_t[:n, 0]),
            2.0 * np.asarray(m.state.desc_db.index[:n]),
            atol=1e-2,
        )

    def test_neighbor_block_untouched(self):
        cfg = small_cfg(number_of_robots=2)
        m = Mapper(cfg)
        # ingest a couple of peer keyframes for robot 1 first
        rng = np.random.RandomState(3)
        for i in range(3):
            p = se3.Pose(jnp.eye(3), jnp.array([0.0, 5.0 + i, 0.0]))
            pre = se3.Pose(jnp.eye(3), jnp.array([0.0, 5.0 + max(i - 1, 0), 0.0]))
            assert m.ingest_peer_descriptor(
                1, i, pre, p, rng.rand(1200).astype(np.float32), stamp=float(i)
            )
        before = np.asarray(m.state.odom_t[cfg.keyframe.max_keyframes :])
        drive(m, 60)  # overflows robot 0's block twice
        after = np.asarray(m.state.odom_t[cfg.keyframe.max_keyframes :])
        np.testing.assert_array_equal(before, after)
        assert m.next_index(1) == 3


class TestCompaction:
    def build(self, n=20, with_loop=True):
        cfg = small_cfg()
        m = Mapper(cfg)
        drive(m, n)
        if with_loop:
            z = se3.between(
                se3.Pose(m.state.opt_R[2], m.state.opt_t[2]),
                se3.Pose(m.state.opt_R[10], m.state.opt_t[10]),
            )
            m.state = M._queue_loop(
                m.state, jnp.array(M.encode_kf(0, 2)), jnp.array(M.encode_kf(0, 10)),
                z, jnp.array(0.05, jnp.float32), cfg,
            )
            m.state, _ = M._drain_queue_and_optimize(m.state, cfg)
        return m, cfg

    def test_loop_anchors_survive(self):
        m, cfg = self.build()
        g0 = m.state.graph
        ne0 = int(g0.num_edges)
        loop_edges0 = [
            (int(g0.i[e]), int(g0.j[e]))
            for e in range(ne0)
            if int(g0.j[e]) != int(g0.i[e]) + 1
        ]
        assert loop_edges0 == [(2, 10)]
        state, evicted = compact_robot(m.state, cfg, 0)
        idx = np.asarray(state.desc_db.index[: int(state.counts[0])])
        assert 2 in idx and 10 in idx, "loop anchor frames must survive"
        g = state.graph
        ne = int(g.num_edges)
        loops = [
            (int(g.i[e]), int(g.j[e]), e)
            for e in range(ne)
            if int(g.j[e]) != int(g.i[e]) + 1
        ]
        assert len(loops) == 1
        a, b, e = loops[0]
        assert int(state.desc_db.index[a]) == 2
        assert int(state.desc_db.index[b]) == 10
        # measurement unchanged
        np.testing.assert_allclose(
            np.asarray(g.z.t[e]), [16.0, 0.0, 0.0], atol=1e-4
        )

    def test_recomposed_chain_exact(self):
        m, cfg = self.build(with_loop=False)
        state, evicted = compact_robot(m.state, cfg, 0)
        assert len(evicted) > 0
        g = state.graph
        ne = int(g.num_edges)
        n = int(state.counts[0])
        assert ne == n - 1, "pure odometry graph: chain edges only (+prior)"
        idx = np.asarray(state.desc_db.index[:n])
        for e in range(ne):
            i, j = int(g.i[e]), int(g.j[e])
            gap = idx[j] - idx[i]
            # poses advance 2m/keyframe on x: composed z spans the gap
            np.testing.assert_allclose(
                np.asarray(g.z.t[e]), [2.0 * gap, 0.0, 0.0], atol=1e-4
            )
            # variance grows with the gap: sqrt_info scales 1/sqrt(gap)
            np.testing.assert_allclose(
                float(g.sqrt_info[e, 3]),
                (1.0 / cfg.optimizer.odometry_sigmas[3]) / np.sqrt(gap),
                rtol=1e-5,
            )

    def test_keep_policy(self):
        m, cfg = self.build()
        keep = plan_keep(m.state, cfg, 0)
        n = int(m.state.counts[0])
        assert keep[0] and keep[2] and keep[10]
        assert keep[n - cfg.keyframe.evict_keep_recent :].all()
        assert not keep.all(), "middle non-anchor frames must be decimated"

    def test_checkpoint_roundtrip_with_archive(self, tmp_path):
        from scl_slam.runtime import checkpoint

        cfg = small_cfg()
        m = Mapper(cfg)
        drive(m, 60)
        path = str(tmp_path / "ck.npz")
        checkpoint.save(m, path)
        m2 = checkpoint.load(Mapper(cfg), path)
        p1, s1 = m.full_trajectory(0)
        p2, s2 = m2.full_trajectory(0)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_allclose(p1, p2, atol=1e-6)

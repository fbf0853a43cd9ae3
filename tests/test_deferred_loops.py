"""Deferred loop factors: factors referencing not-yet-ingested keyframes

stay queued across drains instead of corrupting the graph with identity
poses (reference semantics, distributedMapping.h:790-795)."""
import dataclasses

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
from scl_slam.runtime.state import make_state


def cfg2():
    return SlamConfig(
        number_of_robots=2,
        keyframe=KeyframeConfig(
            max_keyframes=16, points_per_keyframe=512, raw_points_capacity=1024
        ),
        loop=LoopConfig(near_keyframes=2, submap_capacity=1024, queue_capacity=8),
        optimizer=OptimizerConfig(edge_capacity=64, gn_iters=2, cg_iters=8),
        scan_context=ScanContextParams(exclude_recent=2),
    )


def ingest(state, cfg, robot, n, rng):
    for k in range(n):
        xyz = jnp.asarray(rng.uniform(-20, 20, (512, 3)), jnp.float32)
        pose = se3.Pose(jnp.eye(3), jnp.array([2.0 * k, 3.0 * robot, 0.0]))
        state, _ = M._ingest(
            state, jnp.array(robot), pose, xyz, jnp.ones(512, bool),
            jnp.array(0.0, jnp.float32), cfg,
        )
    return state


class TestDeferredLoops:
    def test_unknown_endpoint_deferred_then_added(self):
        cfg = cfg2()
        rng = np.random.RandomState(0)
        state = ingest(make_state(cfg), cfg, robot=0, n=6, rng=rng)
        # factor to robot 1's keyframe 2 — robot 1 has ingested NOTHING yet
        z = se3.Pose(jnp.eye(3), jnp.array([0.0, 3.0, 0.0]))
        state = M._queue_loop(
            state, jnp.array(M.encode_kf(0, 3)), jnp.array(M.encode_kf(1, 2)), z,
            jnp.array(0.05, jnp.float32), cfg,
        )
        edges_before = int(state.graph.num_edges)

        state, _ = M._drain_queue_and_optimize(state, cfg)
        assert int(state.graph.num_edges) == edges_before, "must not add yet"
        assert int(state.loop_queue.count) == 1, "must stay queued"

        # robot 1's chain arrives; next drain admits the factor
        state = ingest(state, cfg, robot=1, n=4, rng=rng)
        state, _ = M._drain_queue_and_optimize(state, cfg)
        # + the deferred loop + robot 1's 3 between edges (its first keyframe
        # adds a prior, not a between)
        assert int(state.graph.num_edges) == edges_before + 1 + 3
        assert int(state.loop_queue.count) == 0

    def test_ready_factors_unaffected(self):
        cfg = cfg2()
        rng = np.random.RandomState(1)
        state = ingest(make_state(cfg), cfg, robot=0, n=8, rng=rng)
        z = se3.Pose(jnp.eye(3), jnp.array([8.0, 0.0, 0.0]))
        state = M._queue_loop(
            state, jnp.array(M.encode_kf(0, 1)), jnp.array(M.encode_kf(0, 5)), z,
            jnp.array(0.05, jnp.float32), cfg,
        )
        before = int(state.graph.num_edges)
        state, _ = M._drain_queue_and_optimize(state, cfg)
        assert int(state.graph.num_edges) == before + 1
        assert int(state.loop_queue.count) == 0

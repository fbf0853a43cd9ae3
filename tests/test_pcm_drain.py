"""PCM wiring in the optimize path: inconsistent queued loops must not

enter the factor graph when use_pcm is enabled."""
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
from scl_slam.geometry import se3, so3
from scl_slam.runtime import mapper as M
from scl_slam.runtime.state import make_state


def build_state(cfg, n=12):
    state = make_state(cfg)
    rng = np.random.RandomState(0)
    for k in range(n):
        xyz = jnp.asarray(rng.uniform(-20, 20, (512, 3)), jnp.float32)
        pose = se3.Pose(jnp.eye(3), jnp.array([2.0 * k, 0.0, 0.0]))
        state, _ = M._ingest(
            state, jnp.array(0), pose, xyz, jnp.ones(512, bool),
            jnp.array(0.0, jnp.float32), cfg,
        )
    return state


def cfg_with_pcm(use_pcm):
    return SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=16, points_per_keyframe=512, raw_points_capacity=1024
        ),
        loop=LoopConfig(near_keyframes=2, submap_capacity=1024, queue_capacity=16),
        optimizer=OptimizerConfig(
            edge_capacity=64, gn_iters=3, cg_iters=16,
            use_pcm=use_pcm, pcm_threshold=0.5,
        ),
        scan_context=ScanContextParams(exclude_recent=2),
    )


def queue_loops(state, cfg):
    # consistent loops: z matches the true between (poses 2 m apart on x)
    for (i, j) in [(0, 8), (1, 9), (2, 10), (3, 11)]:
        z = se3.Pose(jnp.eye(3), jnp.array([2.0 * (j - i), 0.0, 0.0]))
        state = M._queue_loop(
            state, jnp.array(i), jnp.array(j), z, jnp.array(0.05, jnp.float32), cfg
        )
    # one wildly inconsistent loop
    bad = se3.Pose(
        so3.from_euler(jnp.array([0.0, 0.0, 2.0])), jnp.array([-15.0, 9.0, 2.0])
    )
    state = M._queue_loop(
        state, jnp.array(4), jnp.array(7), bad, jnp.array(0.05, jnp.float32), cfg
    )
    return state


class TestPCMDrain:
    def test_outlier_rejected_with_pcm(self):
        cfg = cfg_with_pcm(True)
        state = queue_loops(build_state(cfg), cfg)
        edges_before = int(state.graph.num_edges)
        state, _ = M._drain_queue_and_optimize(state, cfg)
        added = int(state.graph.num_edges) - edges_before
        assert added == 4, f"PCM must drop the outlier: added {added}"

    def test_outlier_admitted_without_pcm(self):
        cfg = cfg_with_pcm(False)
        state = queue_loops(build_state(cfg), cfg)
        edges_before = int(state.graph.num_edges)
        state, _ = M._drain_queue_and_optimize(state, cfg)
        added = int(state.graph.num_edges) - edges_before
        assert added == 5

"""Benchmarks: the three BASELINE.md north-star metrics on one GPU.

Prints ONE JSON line PER METRIC
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "platform": "gpu", "device_kind": ..., "device_count": N}
each flushed the moment its metric completes:

1. ``retrieval_queries_per_s`` — two-stage loop-closure retrieval
   (ring-key top-k + all-shift cosine verification) in 256-query batches
   over a full 4096-keyframe DB. Baseline: the reference queries once
   per keyframe at sensor rate = 10 queries/s.
2. ``fleet_frames_per_s`` — multi-robot serving via FleetMapper: mixed
   2-robot keyframe batches through the fused ingest+detect+inter-verify
   step. Baseline: 2 robots x sensor rate = 20 frames/s.
3. ``keyframe_pipeline_frames_per_s`` — full per-keyframe work
   (descriptor build + DB insert + retrieval + shifted-distance
   verification + submap ICP + queue bookkeeping) on synthetic KITTI-scale
   inputs as scanned 6x32-keyframe chunks (Mapper.replay — the rosbag
   replay analog). Baseline: sensor-rate real time on the reference's
   4-core onboard CPU = 10 frames/s.

Run: ``python bench.py``. Without a GPU it exits non-zero before any
metric; a metric that fails stops the run with a non-zero exit. Every
timed region ends with a host copy of a small output.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def bench_retrieval(jax, jnp):
    from scl_slam.descriptors import scan_context as sc

    CFG = sc.ScanContextConfig()
    K = 4096
    R, S = CFG.num_rings, CFG.num_sectors
    rng = np.random.RandomState(0)
    imgs = rng.rand(K, R, S).astype(np.float32) * 8.0
    keys = imgs.mean(axis=2)
    db = sc.make_db(K, CFG)
    db = db._replace(
        descriptors=jnp.asarray(imgs),
        keys=jnp.asarray(keys),
        robot=jnp.zeros((K,), jnp.int32),
        index=jnp.arange(K, dtype=jnp.int32),
        count=jnp.array(K, jnp.int32),
    )
    B = 256
    sel = rng.randint(0, K - CFG.exclude_recent - 1, B)
    q_imgs = jnp.asarray(imgs[sel])
    q_keys = jnp.asarray(keys[sel])
    q_robots = jnp.zeros((B,), jnp.int32)
    q_indices = jnp.full((B,), K - 1, jnp.int32)

    @jax.jit
    def run(q):
        return sc.query_batch(
            db, q, q_keys, q_robots, q_indices, CFG, mode="intra"
        )

    m = run(q_imgs)
    jax.block_until_ready(m)
    correct = int(np.sum(np.asarray(m.index) == sel))
    assert correct == B, f"retrieval correctness {correct}/{B}"

    CHAIN = 50
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        q = q_imgs
        o = None
        for _ in range(CHAIN):
            o = run(q)
            q = q_imgs + 0.0 * o.distance[0]   # serialize without extra work
        _ = np.asarray(o.index).ravel()[:1]    # host copy ends the timing
        best = min(best, (time.perf_counter() - t0) / CHAIN)
    qps = B / best
    return {
        "metric": "retrieval_queries_per_s",
        "value": round(qps, 0),
        "unit": "queries/s",
        "vs_baseline": round(qps / 10.0, 1),
    }


def bench_fleet(jax, jnp):
    from scl_slam.config import (
        KeyframeConfig,
        LoopConfig,
        OptimizerConfig,
        SlamConfig,
    )
    from scl_slam.runtime.fleet import _fleet_step
    from scl_slam.runtime.state import make_state

    n_pts = 65536
    cfg = SlamConfig(
        number_of_robots=2,
        keyframe=KeyframeConfig(
            max_keyframes=2048,
            points_per_keyframe=4096,
            raw_points_capacity=n_pts,
        ),
        loop=LoopConfig(
            near_keyframes=25,
            submap_capacity=8192,
            icp_iterations=20,
        ),
        optimizer=OptimizerConfig(
            edge_capacity=2048,
            gn_iters=4,
            cg_iters=32,
        ),
    )
    rng = np.random.RandomState(1)

    def scan(k):
        n = n_pts
        theta = rng.uniform(-np.pi, np.pi, n)
        r = rng.uniform(2, 75, n)
        z = np.sin(theta * 3 + k * 0.1) * 2 + rng.normal(0, 0.4, n) - 1.0
        return np.stack(
            [r * np.cos(theta), r * np.sin(theta), z], -1
        ).astype(np.float32)

    # mixed 2-robot keyframe batches, pre-staged on device (input transfer
    # is measured by neither this nor the headline bench — same discipline:
    # the serving step is the system under test). One staged scan batch is
    # reused across steps with shifted poses — the DB keeps growing, so
    # each step still does fresh retrieval work.
    B, n_steps = 16, 4
    total = B * n_steps
    eye = jnp.eye(3)
    robots = jnp.asarray([k % 2 for k in range(B)], jnp.int32)
    xs = jnp.asarray(np.stack([scan(k) for k in range(B)]))
    pose_ts = [
        jnp.asarray(
            np.stack(
                [
                    [2.0 * (s * B + k), 4.0 * (k % 2), 0.0]
                    for k in range(B)
                ]
            ),
            jnp.float32,
        )
        for s in range(n_steps)
    ]
    masks = jnp.ones((B, n_pts), bool)
    pose_R = jnp.broadcast_to(eye, (B, 3, 3))
    stamps = jnp.zeros((B,), jnp.float32)
    key = jax.random.PRNGKey(0)

    # compile + warm on a throwaway state (donated arg: fresh state per run)
    state = make_state(cfg)
    out = _fleet_step(
        state, key, robots, pose_R, pose_ts[0], xs, masks, stamps, cfg
    )
    jax.block_until_ready(out[0].counts)
    _ = np.asarray(out[2][0])

    state = make_state(cfg)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    k = key
    outs = None
    for s in range(n_steps):
        state, k, outs = _fleet_step(
            state, k, robots, pose_R, pose_ts[s], xs, masks, stamps, cfg
        )
    _ = np.asarray(outs[0])                       # host copy ends the timing
    dt = time.perf_counter() - t0
    fps = total / dt
    return {
        "metric": "fleet_frames_per_s",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 20.0, 2),
    }


def bench_pipeline(jax, jnp):
    from scl_slam.config import (
        KeyframeConfig,
        LoopConfig,
        OptimizerConfig,
        ScanContextParams,
        SlamConfig,
    )
    from scl_slam.geometry import se3
    from scl_slam.runtime.mapper import _replay_batches
    from scl_slam.runtime.state import make_state

    n_pts = 65536
    cfg = SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=4096,  # KITTI-00-scale DB capacity
            points_per_keyframe=4096,
            raw_points_capacity=n_pts,
        ),
        loop=LoopConfig(
            near_keyframes=25,
            submap_capacity=8192,
            icp_iterations=20,
        ),
        optimizer=OptimizerConfig(
            edge_capacity=2048,
            gn_iters=6,
            cg_iters=48,
        ),
        scan_context=ScanContextParams(),
    )
    state = make_state(cfg)
    rng = np.random.RandomState(0)

    def scan(k):
        n = n_pts
        theta = rng.uniform(-np.pi, np.pi, n)
        r = rng.uniform(2, 75, n)
        z = np.sin(theta * 3 + k * 0.1) * 2 + rng.normal(0, 0.4, n) - 1.0
        return np.stack(
            [r * np.cos(theta), r * np.sin(theta), z], -1
        ).astype(np.float32)

    # B=32 macro-batches, R=6 scanned inside ONE device program per
    # dispatch (the scan amortizes per-dispatch cost over 192 frames)
    B, R = 32, 6
    xs = jnp.asarray(
        np.stack([scan(k) for k in range(R * B)]).reshape(R, B, n_pts, 3)
    )
    masks = jnp.ones((R, B, n_pts), bool)
    pose_R = jnp.broadcast_to(jnp.eye(3), (R, B, 3, 3))
    pose_t = jnp.asarray(
        np.stack(
            [[1.0 * (i * B + k), 0.0, 0.0] for i in range(R) for k in range(B)]
        ).reshape(R, B, 3),
        jnp.float32,
    )
    stamps = jnp.zeros((R, B))

    def chunk_step(state):
        return _replay_batches(
            state, jnp.array(0), se3.Pose(pose_R, pose_t), xs, masks, stamps, cfg
        )

    out = chunk_step(state)
    jax.block_until_ready(out)
    _ = np.asarray(out[3])

    n_rep = 3
    states = [make_state(cfg) for _ in range(n_rep)]
    jax.block_until_ready(states)
    t0 = time.perf_counter()
    outs = [chunk_step(states[i]) for i in range(n_rep)]
    _ = [np.asarray(o[3]) for o in outs]
    dt = time.perf_counter() - t0
    fps = n_rep * R * B / dt
    return {
        "metric": "keyframe_pipeline_frames_per_s",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 10.0, 2),
    }


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(
            f"bench.py needs a GPU; JAX found {jax.default_backend()!r}"
        )
    import jax.numpy as jnp

    dev = jax.devices()[0]
    for fn in (bench_retrieval, bench_fleet, bench_pipeline):
        rec = fn(jax, jnp)
        rec.update(
            platform=dev.platform,
            device_kind=dev.device_kind,
            device_count=len(jax.devices()),
        )
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()

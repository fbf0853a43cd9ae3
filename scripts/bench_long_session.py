#!/usr/bin/env python
"""Long-session sustained throughput: 1500+ keyframes through Mapper.replay.

The driver bench (bench.py) replays 192 frames into an EMPTY database —
the cold-start number. This measures the production regime: a growing
(then full) DB, retrieval against thousands of resident descriptors,
rising loop-hit rates, periodic drains (pose-graph solves), and — past
capacity — live eviction/compaction. Reports per-chunk frames/s so the
warm-DB trend is visible, plus end-state integrity checks.

    python scripts/bench_long_session.py [--frames 1536]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.config import (
    KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig,
)
from scl_slam.geometry import se3
from scl_slam.runtime import Mapper


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1536)
    ap.add_argument("--transfer", choices=["f32", "int16"], default="f32",
                    help="int16 = 5 mm fixed-point scan staging (halves the\n"
                    "host->device bytes)")
    ap.add_argument("--max-keyframes", type=int, default=4096,
                    help="a capacity below --frames exercises live eviction "
                    "too, at the cost of compiling the compaction programs; "
                    "eviction correctness is covered by "
                    "tests/test_eviction.py")
    args = ap.parse_args()

    # deliberately IDENTICAL to bench.py's pipeline config so the big
    # scanned replay program loads from the persistent compile cache
    cfg = SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=args.max_keyframes,
            points_per_keyframe=4096,
            raw_points_capacity=65536,
        ),
        loop=LoopConfig(
            near_keyframes=25, submap_capacity=8192, icp_iterations=20
        ),
        optimizer=OptimizerConfig(edge_capacity=2048, gn_iters=6, cg_iters=48),
        scan_context=ScanContextParams(),
    )
    m = Mapper(cfg)
    rng = np.random.RandomState(0)

    def scan(k):
        n = 65536
        theta = rng.uniform(-np.pi, np.pi, n)
        r = rng.uniform(2, 75, n)
        z = np.sin(theta * 3 + k * 0.1) * 2 + rng.normal(0, 0.4, n) - 1.0
        return np.stack(
            [r * np.cos(theta), r * np.sin(theta), z], -1
        ).astype(np.float32)

    B, R = 32, 6
    chunk = B * R
    n_chunks = args.frames // chunk
    print(f"backend: {jax.default_backend()}; {n_chunks} chunks of {chunk} "
          f"frames, capacity {args.max_keyframes}, transfer {args.transfer}",
          flush=True)

    total_loops = 0
    times = []
    t_wall0 = time.perf_counter()
    for c in range(n_chunks):
        base = c * chunk
        poses = [
            se3.Pose(jnp.eye(3), jnp.array([1.0 * (base + k), 0.0, 0.0]))
            for k in range(chunk)
        ]
        scans = [scan(base + k) for k in range(chunk)]
        stamps = [0.1 * (base + k) for k in range(chunk)]
        t0 = time.perf_counter()
        out = m.replay(poses, scans, stamps, apply_gate=False,
                       batch=B, chunk_batches=R, transfer=args.transfer)
        n_loops = sum(1 for l in out["loops"] if l)
        # drain the loop queue like the serving cadence would
        chi = m.optimize()
        _ = np.asarray(chi)[:1]          # host copy ends the timing
        dt = time.perf_counter() - t0
        total_loops += n_loops
        fps = chunk / dt
        times.append((fps, dt))
        label = "warmup/compile" if c == 0 else ""
        print(f"chunk {c:2d}: {fps:7.1f} frames/s ({dt*1e3:6.0f} ms, "
              f"{n_loops:3d} loops, kf={m._keyframes}) {label}", flush=True)

    wall = time.perf_counter() - t_wall0
    steady = [f for f, _ in times[1:]]
    tr = m.trajectory()
    ok = np.isfinite(tr).all()
    print(f"\nsustained (excl. chunk 0): median {np.median(steady):.1f} "
          f"frames/s, min {min(steady):.1f}, max {max(steady):.1f}")
    print(f"total: {n_chunks * chunk} frames, {total_loops} loops, "
          f"{wall:.1f}s wall; resident kf {int(sum(np.asarray(m.state.counts)))}"
          f" (capacity {args.max_keyframes}); trajectory finite: {ok}")


if __name__ == "__main__":
    main()

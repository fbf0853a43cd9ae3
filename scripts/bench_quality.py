#!/usr/bin/env python
"""Quality-at-scale anchor: 1,200-keyframe realistic-proxy session -> ATE.

The BASELINE north star ("KITTI 00/05/08 ATE within the reference bound")
is unmeasurable here — the environment has no KITTI data — so this is the
closest attainable stand-in, and the QUALITY analog of bench.py's perf
gate: a full urban session at reference-default thresholds through every
at-scale mechanism at once —

- 3 laps of the urban proxy world (io/lidar_sim.py, ~60k-point
  ring-structured scans) with lane-offset revisits = 1,248 keyframes at
  the reference's 1 m cadence;
- drifted odometry (random-walk noise, the realistic LIO error process
  from tests/test_realistic_proxy.py);
- the SCANNED macro-batch replay path (Mapper.replay, 6x32 chunks) with a
  drain (pose-graph solve) after every chunk;
- live EVICTION: capacity 1024 < 1,248 keyframes, so the 3rd lap runs
  compaction while loops keep closing (full_trajectory merges the
  archive back for evaluation).

Emits ONE JSON line:
  {"metric": "quality_ate_m", "value": <optimized ATE>,
   "ate_odom_m": <dead-reckoning ATE>, "ratio": value/ate_odom, ...}
and exits 1 if the checked-in golden bound (tests/golden/quality_ate.json)
is exceeded — a quality regression fails exactly like a perf one.

Run:  python scripts/bench_quality.py                         # GPU
      python scripts/bench_quality.py --quick --platform cpu  # smoke

The pipeline config is the realistic-density one (8192 pts/keyframe,
16384-pt submaps — the fitness-as-variance noise model needs this
density, see tests/test_realistic_proxy.py docstring), a different
program shape from bench.py's, so its first run compiles its own
programs.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import subprocess

import jax
import jax.numpy as jnp
import numpy as np


def build_gt(scene, laps):
    """Lap sequence with lane-offset revisits: [N] 4x4 world poses."""
    gt = []
    for offset in laps:
        gt += scene.circuit(lane_offset=offset, step=1.0)
    return gt


def drift_odometry(gt, seed=3, rot_sigma=0.002, trans_sigma=0.02):
    """Random-walk-corrupted odometry chain (the realistic LIO error
    process; a systematic bias would be model-inconsistent and the MAP
    estimate would rightly refuse to bend the chain — see
    tests/test_realistic_proxy.py)."""
    from scl_slam.geometry import se3

    rng = np.random.RandomState(seed)
    odom = [se3.Pose(jnp.asarray(gt[0][:3, :3], jnp.float32),
                     jnp.asarray(gt[0][:3, 3], jnp.float32))]
    for k in range(1, len(gt)):
        inc_np = np.linalg.inv(gt[k - 1]) @ gt[k]
        noise = se3.exp(jnp.asarray(
            np.concatenate([rng.randn(3) * rot_sigma,
                            rng.randn(3) * trans_sigma]), jnp.float32))
        inc = se3.Pose(jnp.asarray(inc_np[:3, :3], jnp.float32),
                       jnp.asarray(inc_np[:3, 3], jnp.float32))
        odom.append(se3.compose(odom[-1], se3.compose(inc, noise)))
    return odom


def anchor_config(max_kf, quick=False):
    """Reference-default thresholds at realistic density (the
    tests/test_realistic_proxy.py operating point: SC gate 0.14, fitness
    gate 0.3, 1 m cadence, 8192/16384 storage density)."""
    from scl_slam.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams,
        SlamConfig,
    )
    from scl_slam.io.lidar_sim import SENSOR_HEIGHT

    return SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=max_kf,
            points_per_keyframe=2048 if quick else 8192,
            raw_points_capacity=65536 if quick else 131072,
            distance_threshold=1.0,
            angle_threshold=0.2,
        ),
        loop=LoopConfig(
            near_keyframes=6,
            submap_capacity=4096 if quick else 16384,
            history_fitness_score=0.3,
            icp_iterations=30,
            icp_max_corr_dist=10.0,
        ),
        optimizer=OptimizerConfig(edge_capacity=2048, gn_iters=5, cg_iters=32),
        scan_context=ScanContextParams(lidar_height=SENSOR_HEIGHT),
    )


def run_session(m, sim, gt, odom, batch, chunk_batches, tag=""):
    """Replay the session through ``m.replay`` in ``batch`` x
    ``chunk_batches`` chunks with a drain (pose-graph solve) after every
    chunk. Returns the number of keyframes that closed a loop."""
    n = len(gt)
    chunk = batch * chunk_batches
    loops = 0
    pos = 0
    t0 = time.time()
    while pos < n:
        idx = list(range(pos, min(n, pos + chunk)))
        scans = [sim.scan_at(gt[k], seed=k) for k in idx]
        out = m.replay(
            [odom[k] for k in idx], scans,
            stamps=[1.0 * k for k in idx],
            apply_gate=False, batch=batch, chunk_batches=chunk_batches,
        )
        loops += sum(1 for l in out["loops"] if l)
        chi = m.optimize()                       # drain every chunk
        _ = np.asarray(chi)[:1]                  # host copy ends timing
        pos += len(idx)
        print(f"{tag} fed {pos}/{n} kf={m._keyframes} loops={loops} "
              f"resident={int(np.asarray(m.state.counts).sum())} "
              f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    return loops


def session_ate(m, gt, odom):
    """(ATE of the optimized keyframe trajectory, ATE of dead reckoning),
    both unaligned RMSE in meters against the keyframes' ground truth."""
    from scl_slam.geometry import se3
    from scl_slam.io import trajectory as tio

    est, stamps = m.full_trajectory()
    kf_idx = [int(round(float(s))) for s in stamps]
    kf_gt = np.stack([gt[i] for i in kf_idx])
    dead = np.stack([np.asarray(se3.to_matrix(odom[i])) for i in kf_idx])
    return (tio.ate_rmse(est, kf_gt, align=False),
            tio.ate_rmse(dead, kf_gt, align=False))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    ap.add_argument("--quick", action="store_true",
                    help="reduced scale (1 lap, 512-azimuth scans, no "
                    "eviction) — CPU smoke, NOT the anchor")
    ap.add_argument("--azimuth", type=int, default=1024)
    ap.add_argument("--max-keyframes", type=int, default=1024)
    ap.add_argument("--update-golden", action="store_true",
                    help="write the measured numbers as the new golden "
                    "bound instead of gating on it")
    args = ap.parse_args()

    from scl_slam.utils import platform

    platform.select(args.platform)

    from scl_slam.io.lidar_sim import LidarSim, UrbanScene
    from scl_slam.runtime import Mapper

    t0 = time.time()
    scene = UrbanScene(seed=7, blocks=1, block_size=40.0)
    azimuth = 512 if args.quick else args.azimuth
    sim = LidarSim(scene, n_azimuth=azimuth)
    # 6 lane-offset laps of the ~208-pose circuit = 1,248 keyframes; the
    # later laps revisit every earlier lane (loop-dense) and run past the
    # 1,024 capacity (live eviction)
    laps = [0.0] if args.quick else [0.0, 2.0, 1.0, 3.0, 0.5, 2.5]
    gt = build_gt(scene, laps)
    odom = drift_odometry(gt)
    n = len(gt)
    max_kf = min(args.max_keyframes, 256) if args.quick else args.max_keyframes

    m = Mapper(anchor_config(max_kf, quick=args.quick))
    print(f"[quality] backend={jax.default_backend()} frames={n} "
          f"capacity={max_kf} azimuth={azimuth}", file=sys.stderr, flush=True)

    B, R = (8, 2) if args.quick else (32, 6)
    loops = run_session(m, sim, gt, odom, B, R, tag="[quality]")
    ate_opt, ate_dead = session_ate(m, gt, odom)
    evicted = sum(len(v) for v in m._evicted.values())

    golden_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "golden", "quality_ate.json",
    )
    rec = {
        "metric": "quality_ate_m",
        "value": round(ate_opt, 3),
        "unit": "m",
        "ate_odom_m": round(ate_dead, 3),
        "ratio": round(ate_opt / max(ate_dead, 1e-9), 3),
        "keyframes": m._keyframes,
        "evicted": evicted,
        "loops": loops,
        "platform": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "wall_s": round(time.time() - t0, 1),
    }
    if args.platform == "gpu":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
    rc = 0
    if args.quick:
        rec["note"] = "quick mode — not the anchor, no golden gate"
    elif args.update_golden:
        with open(golden_path, "w") as f:
            json.dump({"ate_opt_bound": round(ate_opt * 1.25, 3),
                       "ratio_bound": round(
                           min(0.9, ate_opt / max(ate_dead, 1e-9) * 1.3), 3),
                       "measured": rec}, f, indent=1)
        rec["golden_updated"] = golden_path
    elif os.path.exists(golden_path):
        gold = json.load(open(golden_path))
        rec["golden_bound"] = gold["ate_opt_bound"]
        if ate_opt > gold["ate_opt_bound"] or (
            ate_opt / max(ate_dead, 1e-9) > gold["ratio_bound"]
        ):
            rec["regression"] = True
            rc = 1
    print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

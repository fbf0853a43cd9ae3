"""CLI pipeline runner — the launch-system replacement.

The reference is driven by roslaunch + rosbag replay
(``launch/single_ugv.launch``, ``launch/test_distributed_loop.launch``); here
one command runs the full pipeline on a KITTI sequence or the synthetic
world, exports TUM/KITTI trajectories, and reports ATE when ground truth is
available:

    python -m scl_slam.run --dataset synthetic --frames 120
    python -m scl_slam.run --dataset kitti --root /data/kitti --sequence 00
    python -m scl_slam.run --config my_config.yaml ...

Multi-robot (N namespaced mappers fed by index-split sequences — the analog
of the reference's per-robot bag splits) lives in ``scl_slam.run_multi``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description="scl_slam single-robot pipeline")
    p.add_argument("--dataset", choices=["synthetic", "kitti"], default="synthetic")
    p.add_argument("--root", help="KITTI odometry root (contains sequences/, poses/)")
    p.add_argument("--sequence", default="00")
    p.add_argument("--frames", type=int, default=120, help="max frames to process")
    p.add_argument("--config", help="YAML config path")
    p.add_argument("--output", default="/tmp/scl_slam_run")
    p.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    p.add_argument("--odom-drift", type=float, default=0.05,
                   help="synthetic: random-walk odometry noise sigma "
                   "(m/frame translation; rotation sigma is 1/10 of it). "
                   "A random walk matches the optimizer's noise model, so "
                   "loop closures genuinely correct it — a SYSTEMATIC "
                   "per-frame bias would be 10+ sigma inconsistent with "
                   "the model and the MAP rightly refuses to bend the "
                   "chain (measured; see tests/test_realistic_proxy.py)")
    p.add_argument("--figure", dest="figure", action="store_true",
                   default=True,
                   help="write trajectory.png (paths + loop chords + map) "
                   "to --output (default on)")
    p.add_argument("--no-figure", dest="figure", action="store_false")
    p.add_argument("--loader", choices=["python", "native"], default="python",
                   help="kitti scan reader: python (numpy fromfile) or "
                   "native (threaded C++ prefetcher, native/dataloader.cpp "
                   "— overlaps disk reads with the device pipeline)")
    p.add_argument("--odometry", choices=["gt", "icp", "imu"], default="gt",
                   help="odometry source: gt = dataset poses (+injected "
                   "drift for synthetic); icp = in-framework scan-to-map "
                   "point-to-plane odometry; imu = ICP fused with the "
                   "15-state IMU window smoother (IMU synthesized from the "
                   "dataset motion — the full-LIO front-end path). For "
                   "synthetic icp/imu use >= ~60 frames: below that the "
                   "10 m radius floor widens frame spacing past the ICP "
                   "correspondence gate (63 frames: ATE 0.30 m, 23 loops)")
    p.add_argument("--deskew", choices=["none", "const", "gyro"],
                   default="none",
                   help="motion compensation in the icp/imu front end "
                   "(ops/deskew.py): const = constant-twist from the "
                   "motion prediction; gyro = gyro-integrated rotation "
                   "trajectory (imu mode). The synthetic worlds render "
                   "unskewed scans — use with real spinning-LiDAR data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=0, metavar="B",
                   help="replay mode: process frames through the macro-"
                   "batched Mapper.add_frames path, B frames per device "
                   "program (requires --odometry gt; 0 = sequential "
                   "add_frame, the live mode)")
    p.add_argument("--replay-chunks", type=int, default=0, metavar="R",
                   help="with --batch B: scan R macro-batches inside ONE "
                   "device program per chunk (Mapper.replay) — amortizes "
                   "the per-dispatch cost; 0 = one program per batch")
    return p


def _emit_figure(args, mapper, est, dead, gt_poses, report):
    """Write the offline run figure (trajectory + loop chords + map) and
    record its path in the report. Never fails the run."""
    if not args.figure:
        return
    import os

    try:
        from .io import viz

        sub = None
        if "ate_rmse_m" in report and "ate_rmse_odom_only_m" in report:
            sub = (
                f"ATE {report['ate_rmse_m']:.3f} m optimized vs "
                f"{report['ate_rmse_odom_only_m']:.3f} m odometry-only  ·  "
                f"{report['loops_closed']} loops"
            )
        elif "ate_rmse_m" in report:
            sub = (
                f"ATE {report['ate_rmse_m']:.3f} m  ·  "
                f"{report['loops_closed']} loops"
            )
        report["figure"] = viz.save_run_figure(
            os.path.join(args.output, "trajectory.png"),
            est,
            odom=dead,
            gt=gt_poses,
            loops=mapper.loop_constraints(),
            map_points=mapper.global_map(max_points=1 << 16),
            title=f"scl_slam — {args.dataset}, {report['frames']} frames",
            subtitle=sub,
        )
    except Exception as e:  # the figure is auxiliary output
        report["figure_error"] = str(e)


def _run_batched(args, mapper, n, get_scan, get_odom, gt_of, tio, se3, jnp):
    """Replay mode: fixed-size chunks through Mapper.add_frames (one device

    program per chunk), optimize throttling via spin_once as in live mode.
    The trailing partial chunk goes through sequential add_frame so only one
    batch size ever compiles."""
    import json as _json

    B = args.batch
    t_start = time.perf_counter()
    n_loops = 0
    kf_frames = []

    def pose_of(k):
        T = get_odom(k)
        return se3.Pose(
            jnp.asarray(T[:3, :3], jnp.float32), jnp.asarray(T[:3, 3], jnp.float32)
        )

    if args.replay_chunks > 0:
        frames = list(range(n))
        out = mapper.replay(
            [pose_of(i) for i in frames],
            [get_scan(i) for i in frames],
            stamps=[0.1 * i for i in frames],
            batch=B,
            chunk_batches=args.replay_chunks,
        )
        kf_frames.extend(i for i, a in zip(frames, out["accepted"]) if a)
        n_loops += sum(1 for l in out["loops"] if l)
    else:
        k = 0
        while k + B <= n:
            frames = list(range(k, k + B))
            out = mapper.add_frames(
                [pose_of(i) for i in frames],
                [get_scan(i) for i in frames],
                stamps=[0.1 * i for i in frames],
            )
            kf_frames.extend(i for i, a in zip(frames, out["accepted"]) if a)
            n_loops += sum(1 for l in out["loops"] if l)
            mapper.spin_once()
            k += B
        for i in range(k, n):
            wire = mapper.add_frame(pose_of(i), get_scan(i), stamp=0.1 * i)
            if wire is not None:
                kf_frames.append(i)
                if mapper.spin_once().get("loop"):
                    n_loops += 1
    mapper.optimize()
    wall = time.perf_counter() - t_start

    mapper.save_trajectories(args.output)
    est = mapper.trajectory()
    report = {
        "frames": n,
        "keyframes": len(est),
        "loops_closed": n_loops,
        "wall_s": round(wall, 2),
        "frames_per_s": round(n / wall, 2),
        "batch": B,
        "output": args.output,
    }
    gt_poses = dead = None
    if gt_of(0) is not None:
        gt_poses = np.stack([gt_of(i) for i in kf_frames])
        report["ate_rmse_m"] = round(tio.ate_rmse(est, gt_poses), 4)
        dead = np.stack([np.asarray(get_odom(i)) for i in kf_frames])
        report["ate_rmse_odom_only_m"] = round(tio.ate_rmse(dead, gt_poses), 4)
    _emit_figure(args, mapper, est, dead, gt_poses, report)
    print(_json.dumps(report))
    return 0


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from .utils import platform

    platform.select(args.platform)

    import jax.numpy as jnp

    from .config import SlamConfig, load_config
    from .geometry import se3
    from .io import kitti as kio
    from .io import trajectory as tio
    from .runtime import Mapper

    if args.config:
        cfg = load_config(args.config)
    elif args.dataset == "synthetic":
        # demo-scale defaults: the KITTI-tuned exclusion window (100
        # keyframes) would block every loop in a short run, the synthetic
        # sampling density needs denser keyframe storage for ICP to verify
        # under drift, and short sessions don't need 4096-keyframe capacity
        import dataclasses

        from .config import KeyframeConfig, ScanContextParams

        cfg = SlamConfig()
        # the demo KNOWS its odometry error process (--odom-drift is the
        # injected random-walk sigma), so the noise model states it: a MAP
        # solve with odometry claimed 5x more precise than it is barely
        # bends the chain no matter how many loops close
        d = max(args.odom_drift, 1e-4)
        cfg = dataclasses.replace(
            cfg,
            keyframe=KeyframeConfig(
                max_keyframes=512,
                points_per_keyframe=8192,
                raw_points_capacity=32768,
                distance_threshold=1.0,
                descript_leaf_size=0.3,
            ),
            scan_context=ScanContextParams(
                exclude_recent=15, distance_threshold=0.25
            ),
            loop=dataclasses.replace(
                cfg.loop,
                history_fitness_score=8.0,
                submap_capacity=16384,
                near_keyframes=15,
            ),
            optimizer=dataclasses.replace(
                cfg.optimizer,
                odometry_sigmas=(d * 0.1,) * 3 + (d,) * 3,
                # fitness-as-variance calibration: this world's fitness
                # floor is its sampling spacing (~2-8 m^2 — why the gate
                # above is 8.0, not the reference 0.3), while the actual
                # post-ICP alignment error is cm-scale; the raw convention
                # would hand loop factors meter-scale sigmas. Same
                # density-dependence note as tests/test_pipeline.py.
                loop_noise_scale=0.01,
            ),
        )
    else:
        cfg = SlamConfig()
    mapper = Mapper(cfg)

    if args.loader == "native" and args.dataset != "kitti":
        print("--loader native requires --dataset kitti (the synthetic "
              "world has no .bin files to prefetch)", file=sys.stderr)
        return 2
    if args.dataset == "kitti":
        if not args.root:
            print("--root required for kitti", file=sys.stderr)
            return 2
        seq = kio.KittiSequence(args.root, args.sequence)
        n = min(len(seq), args.frames)
        if args.loader == "native":
            # threaded C++ .bin prefetcher (native/dataloader.cpp): disk
            # reads overlap the device pipeline; frames stream IN ORDER,
            # which is exactly how the run loop consumes them
            import os as _os

            from .io.native_loader import NativeScanLoader

            paths = [
                _os.path.join(seq.velo_dir, f) for f in seq.frames[:n]
            ]
            stream = iter(NativeScanLoader(paths))
            next_k = [0]

            def get_scan(k):
                assert k == next_k[0], "native loader streams in order"
                xyz, m = next(stream)
                next_k[0] += 1
                return xyz[:m]
        else:
            get_scan = seq.scan
        get_odom = seq.gt_pose_velo  # stand-in odometry (front ends live upstream)
        gt_of = seq.gt_pose_velo
    else:
        world = kio.SyntheticWorld(
            seed=args.seed, extent=120.0, pts_per_cluster=800, max_range=50.0
        )
        # frame spacing stays ~1.5 m (sensor-rate scale; the ICP odometry
        # correspondence gate assumes it): up to two laps so revisits
        # close loops everywhere, but SHORT runs reduce the lap count
        # instead of letting the 10 m radius floor widen the spacing
        # (laps=2.0 at 25 frames meant 5 m/frame — ICP odometry diverged,
        # ATE 7.6 m; with the spacing-derived lap count it matches the
        # pre-round-4 short-run geometry)
        laps = float(min(2.0, max(1.25, args.frames * 1.5 / (2 * np.pi * 10.0))))
        radius = max(10.0, args.frames * 1.5 / (2 * np.pi * laps))
        gt = kio.loop_trajectory(n_frames=args.frames, radius=radius, laps=laps)
        n = args.frames
        # random-walk odometry noise (sigma = --odom-drift m/frame, rot
        # sigma 1/10 of it): the realistic LIO error process the
        # optimizer's noise model describes, so corrections are visible
        drift_rng = np.random.RandomState(args.seed + 17)
        odom_accum = [gt[0]]
        for k in range(1, n):
            inc = np.linalg.inv(gt[k - 1]) @ gt[k]
            noise = np.asarray(
                se3.to_matrix(
                    se3.exp(
                        jnp.asarray(
                            np.concatenate(
                                [
                                    drift_rng.randn(3) * args.odom_drift * 0.1,
                                    drift_rng.randn(3) * args.odom_drift,
                                ]
                            ),
                            jnp.float32,
                        )
                    )
                )
            )
            odom_accum.append(odom_accum[-1] @ inc @ noise)
        get_scan = lambda k: world.scan_at(gt[k], max_points=32768, seed=k)
        get_odom = lambda k: odom_accum[k]
        gt_of = lambda k: gt[k]

    odo = None
    fused = None
    if args.odometry == "icp":
        from .runtime.odometry import Odometry, OdometryConfig

        odo = Odometry(OdometryConfig(deskew=args.deskew))
    elif args.odometry == "imu":
        from .runtime import imu as imu_mod
        from .runtime.odometry import ImuFusedOdometry, OdometryConfig

        # 6-node window / 32-sample intervals: at keyframe cadence a longer
        # window adds nothing measurable, and the jacfwd cost scales with both
        fused = ImuFusedOdometry(
            OdometryConfig(deskew=args.deskew), window=6, max_samples=32
        )

    if args.batch:
        if args.odometry != "gt":
            print("--batch requires --odometry gt (precomputed poses)",
                  file=sys.stderr)
            return 2
        return _run_batched(args, mapper, n, get_scan, get_odom, gt_of, tio,
                            se3, jnp)

    t_start = time.perf_counter()
    n_loops = 0
    kf_frames = []
    for k in range(n):
        scan = get_scan(k)
        if fused is not None:
            # IMU stream synthesized from the dataset motion (KITTI odometry
            # ships no IMU; the reference's LIO front ends consume a real one)
            if k == 0:
                acc = np.zeros((1, 3), np.float32)
                gyr = np.zeros((1, 3), np.float32)
                dts = np.zeros((1,), np.float32)
            else:
                acc, gyr, dts = imu_mod.synthesize_between_frames(
                    gt_of(k - 1), gt_of(k), 20, 0.01
                )
            pose, _, _ = fused.step(scan, acc, gyr, dts)
        elif odo is not None:
            pose, _ = odo.step(scan)
        else:
            T = get_odom(k)
            if T is None:
                print("no odometry available (kitti gt missing)", file=sys.stderr)
                return 2
            pose = se3.Pose(
                jnp.asarray(T[:3, :3], jnp.float32), jnp.asarray(T[:3, 3], jnp.float32)
            )
        wire = mapper.add_frame(pose, scan, stamp=0.1 * k)
        if wire is not None:
            kf_frames.append(k)
            info = mapper.spin_once()
            if info.get("loop"):
                n_loops += 1
    mapper.optimize()
    wall = time.perf_counter() - t_start

    mapper.save_trajectories(args.output)
    est = mapper.trajectory()
    report = {
        "frames": n,
        "keyframes": len(est),
        "loops_closed": n_loops,
        "wall_s": round(wall, 2),
        "frames_per_s": round(n / wall, 2),
        "output": args.output,
    }
    gt_poses = dead = None
    if gt_of(0) is not None:
        gt_poses = np.stack([gt_of(k) for k in kf_frames])
        report["ate_rmse_m"] = round(tio.ate_rmse(est, gt_poses), 4)
        if args.odometry == "gt":
            dead = np.stack([np.asarray(get_odom(k)) for k in kf_frames])
            report["ate_rmse_odom_only_m"] = round(tio.ate_rmse(dead, gt_poses), 4)
    _emit_figure(args, mapper, est, dead, gt_poses, report)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Multi-robot pipeline CLI — the ``test_distributed_loop.launch`` analog.

Splits one sequence (synthetic or KITTI) into N per-robot index ranges —
exactly how the reference simulates multi-robot on one machine with
namespaced rosbag replays (``launch/test_distributed_loop.launch:34-58``) —
and runs them in one of three deployment shapes:

- ``--transport local`` (default): N decentralized mappers over the
  in-process bus (reference-parity architecture, one process).
- ``--transport tcp``: N decentralized mappers in N PROCESSES over real
  sockets (``run_robot.py`` workers + ``runtime/transport.py::TcpBus``) —
  the process-per-robot shape the reference deploys over TCPROS.
- ``--fleet``: centralized serving, one shared device state
  (``runtime/fleet.py``) — the beyond-parity single-device mode.

    python -m scl_slam.run_multi --robots 2 --frames 120
    python -m scl_slam.run_multi --robots 2 --transport tcp --platform cpu
    python -m scl_slam.run_multi --robots 3 --dataset kitti --root ... --sequence 05
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def add_dataset_args(p: argparse.ArgumentParser) -> None:
    """Dataset/config args shared with the per-robot worker CLI."""
    p.add_argument("--robots", type=int, default=2)
    p.add_argument("--dataset", choices=["synthetic", "kitti"],
                   default="synthetic")
    p.add_argument("--root")
    p.add_argument("--sequence", default="05")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--config", help="YAML config path (robot identity "
                   "fields are overridden per robot)")
    p.add_argument("--overlap", type=int, default=10,
                   help="frames of overlap between adjacent robot segments")
    p.add_argument("--output", default="/tmp/scl_slam_multi")
    p.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")


def make_cfg(args, r: int):
    """Per-robot config: YAML base (if given) with identity overrides."""
    from .config import SlamConfig, load_config

    base = load_config(args.config) if args.config else SlamConfig()
    return dataclasses.replace(
        base, number_of_robots=args.robots, robot_id=r,
        robot_name=chr(ord("a") + r),
    )


def build_dataset(args):
    """(get_scan, get_pose, n) — deterministic, so every worker process

    rebuilds the identical dataset from the same args."""
    from .io import kitti as kio

    if args.dataset == "kitti":
        if not args.root:
            print("--root required for kitti", file=sys.stderr)
            raise SystemExit(2)  # usage error (run.py contract)
        seq = kio.KittiSequence(args.root, args.sequence)
        n = min(len(seq), args.frames)
        return seq.scan, seq.gt_pose_velo, n
    world = kio.SyntheticWorld(seed=1)
    gt = kio.loop_trajectory(n_frames=args.frames, radius=70.0)
    get_scan = lambda k: world.scan_at(gt[k], max_points=16384, seed=k)
    return get_scan, (lambda k: gt[k]), args.frames


def make_splits(n: int, R: int, overlap: int) -> list[list[int]]:
    """Index split with overlap (the reference's bag splits overlap in
    space)."""
    seg = n // R
    return [
        list(range(max(0, r * seg - overlap), min(n, (r + 1) * seg)))
        for r in range(R)
    ]


def report_view(mapper, get_pose, R: int, output: str) -> dict:
    """Joint ATE + figure from ONE mapper's view of every robot (robot 0's

    view in-process; the worker's own view in tcp mode). Returns the
    report fragment: {"ate_rmse_m": ..., "figure": ...}."""
    from .io import trajectory as tio

    frag: dict = {}
    ates = {}
    trajs = {}
    gts = {}
    if get_pose(0) is None:  # e.g. a KITTI root without poses/<seq>.txt
        frag["ate_rmse_m"] = {}
        return frag
    for r in range(R):
        # one atomic snapshot per robot: separate trajectory()/stamps()
        # calls can straddle a straggling bus-thread ingest in tcp mode,
        # crashing ate_rmse on mismatched lengths (advisor r4)
        est, stamps = mapper.trajectory_with_stamps(robot=r)
        if len(est) == 0:
            continue
        gt_poses = np.stack(
            [np.asarray(get_pose(int(round(float(s) / 0.1)))) for s in stamps]
        )
        label = chr(ord("a") + r)
        ates[label] = round(tio.ate_rmse(est, gt_poses), 4)
        trajs[label] = est
        gts[label] = gt_poses
    frag["ate_rmse_m"] = ates

    try:  # figure is auxiliary output — never fail the run over it
        from .io import viz

        # ONE joint gauge alignment for display: the graph's first-pose
        # prior deliberately leaves yaw + translation free (reference
        # GTSAM prior semantics), so the joint estimate is correct only
        # up to an in-plane rigid gauge; align ALL robots with a single
        # transform (per-robot alignment would hide genuine inter-robot
        # misalignment) and move the loop chords/map with it.
        loops_viz = mapper.loop_constraints()
        map_pts = mapper.global_map(max_points=1 << 16)
        if trajs:
            est_all = np.concatenate(
                [trajs[k][:, :3, 3] for k in sorted(trajs)])
            gt_all = np.concatenate(
                [gts[k][:, :3, 3] for k in sorted(trajs)])
            s, Rw, tw = tio.umeyama_align(est_all, gt_all)

            def apply(T):
                out = T.copy()
                out[:, :3, 3] = (s * (Rw @ T[:, :3, 3].T)).T + tw
                out[:, :3, :3] = Rw @ T[:, :3, :3]
                return out

            trajs = {k: apply(v) for k, v in trajs.items()}
            for lc in loops_viz:
                lc["pi"] = s * (Rw @ np.asarray(lc["pi"])) + tw
                lc["pj"] = s * (Rw @ np.asarray(lc["pj"])) + tw
            if len(map_pts):
                map_pts = (s * (Rw @ np.asarray(map_pts).T)).T + tw
        n_intra = sum(
            not str(lc.get("kind", "")).startswith("inter") for lc in loops_viz
        )
        n_inter = len(loops_viz) - n_intra
        frag["figure"] = viz.save_fleet_figure(
            os.path.join(output, "trajectory.png"),
            trajs,
            gts=gts,
            loops=loops_viz,
            map_points=map_pts,
            title=f"scl_slam — {R} robots",
            subtitle=(f"{n_intra} intra + {n_inter} inter loops  ·  ATE "
                      + ", ".join(f"{k}: {v}" for k, v in ates.items())),
        )
    except Exception as e:
        frag["figure_error"] = str(e)
    return frag


def _gpu_ids() -> list[str]:
    """IDs of the GPUs this process may use, found without starting JAX in
    the supervisor (a JAX process reserves most of a card's memory)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [v.strip() for v in vis.split(",") if v.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def _run_tcp(args) -> int:
    """Spawn one ``run_robot`` process per robot over real sockets.

    With ``--platform gpu`` each worker gets a card of its own through
    ``CUDA_VISIBLE_DEVICES``; with fewer cards than robots the command
    refuses."""
    R = args.robots
    env = [dict(os.environ) for _ in range(R)]
    if args.platform == "gpu":
        gpus = _gpu_ids()
        if len(gpus) < R:
            print(
                f"--transport tcp runs one JAX process per robot, each on "
                f"its own GPU: {len(gpus)} GPU(s) visible for {R} robots. "
                "Use --platform cpu, fewer robots, or run the workers on "
                "separate hosts via run_robot.py directly.",
                file=sys.stderr,
            )
            return 2
        for r in range(R):
            env[r]["CUDA_VISIBLE_DEVICES"] = gpus[r]
    workdir = tempfile.mkdtemp(prefix="scl_slam_tcp_")
    os.makedirs(args.output, exist_ok=True)
    procs = []
    t0 = time.perf_counter()

    def worker_cmd(r: int, ports: str, resume: bool) -> list[str]:
        cmd = [
            sys.executable, "-m", "scl_slam.run_robot",
            "--robot", str(r), "--robots", str(R),
            # each worker binds port 0 itself and publishes the bound
            # port via its ready sentinel — reserving ports here and
            # closing them before the workers re-bind left a TOCTOU
            # window another process could grab (advisor r4)
            "--ports", ports,
            "--workdir", workdir,
            "--dataset", args.dataset, "--frames", str(args.frames),
            "--sequence", args.sequence, "--overlap", str(args.overlap),
            "--output", args.output, "--platform", args.platform,
        ]
        if args.root:
            cmd += ["--root", args.root]
        if args.config:
            cmd += ["--config", args.config]
        if args.checkpoint_every:
            cmd += ["--checkpoint-every", str(args.checkpoint_every)]
        if resume:
            cmd += ["--resume"]
        if args.crash_robot >= 0 and r == args.crash_robot and not resume:
            cmd += ["--crash-after", str(args.crash_after)]
        return cmd

    try:
        for r in range(R):
            procs.append(
                subprocess.Popen(worker_cmd(r, "auto", False), env=env[r])
            )
        # supervise: a worker that dies before writing out_<r> is
        # respawned with --resume, up to --respawn times each (the
        # reference launches every node respawn="true",
        # launch/single_ugv.launch:4). The restarted worker must keep its
        # published port (peers read the ready sentinels once), so the
        # respawn command pins the ports everyone already published.
        restarts = [0] * R
        rcs = [None] * R
        while any(rc is None for rc in rcs):
            time.sleep(0.2)
            for r, pr in enumerate(procs):
                if rcs[r] is not None:
                    continue
                rc = pr.poll()
                if rc is None:
                    continue
                done = os.path.exists(os.path.join(workdir, f"out_{r}"))
                if rc == 0 or done:
                    rcs[r] = rc if rc == 0 else 0
                elif restarts[r] < args.respawn:
                    restarts[r] += 1
                    print(f"worker {r} died rc={rc}; respawn "
                          f"{restarts[r]}/{args.respawn}", file=sys.stderr)
                    try:
                        ports = ",".join(
                            open(os.path.join(workdir, f"ready_{q}")).read()
                            for q in range(R)
                        )
                    except OSError:
                        ports = "auto"  # died before the ready barrier
                    procs[r] = subprocess.Popen(
                        worker_cmd(r, ports, True), env=env[r]
                    )
                else:
                    rcs[r] = rc
            if any(rc not in (None, 0) for rc in rcs):
                # a worker failed PERMANENTLY (respawn budget exhausted):
                # abort the siblings now — they would otherwise block on
                # the dead robot's fed_<r> sentinel until the 900*R-s
                # barrier timeout, die, burn their own respawn budgets,
                # and turn a known failure into a multi-hour hang
                # (code-review r5)
                for q, p2 in enumerate(procs):
                    if rcs[q] is None and p2.poll() is None:
                        p2.terminate()
                        rcs[q] = -15
                break
        wall = time.perf_counter() - t0
        if any(rcs):
            print(f"worker exit codes: {rcs}", file=sys.stderr)
            return 1
        # loop counts summed across workers; robot 0's view is the
        # canonical joint report (in-process parity)
        reps = []
        for rr in range(R):
            with open(os.path.join(workdir, f"out_{rr}")) as f:
                reps.append(json.load(f))
    except BaseException:
        for pr in procs:  # don't orphan workers on Ctrl-C/errors
            if pr.poll() is None:
                pr.terminate()
        raise
    finally:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    n = reps[0]["frames"]
    report = {
        "robots": R,
        "mode": "decentralized-tcp",
        "frames": n,
        "intra_loops": sum(rp["intra_loops"] for rp in reps),
        "inter_loops": sum(rp["inter_loops"] for rp in reps),
        "wall_s": round(wall, 2),
        "frames_per_s": round(n / wall, 2),
        "output": args.output,
        "ate_rmse_m": reps[0]["ate_rmse_m"],
    }
    if "figure" in reps[0]:
        report["figure"] = reps[0]["figure"]
    print(json.dumps(report))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description="scl_slam multi-robot pipeline")
    add_dataset_args(p)
    p.add_argument("--fleet", action="store_true",
                   help="centralized serving: one shared device state for "
                   "all robots (runtime/fleet.py) instead of N decentralized "
                   "mappers over the bus")
    p.add_argument("--transport", choices=["local", "tcp"], default="local",
                   help="decentralized bus: in-process (local) or one "
                   "process per robot over real sockets (tcp)")
    p.add_argument("--respawn", type=int, default=0,
                   help="tcp mode: restart a crashed worker up to N times "
                   "with --resume from its checkpoint (reference launch "
                   "respawn=\"true\", single_ugv.launch:4)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="tcp mode: workers checkpoint every N fed frames "
                   "(needed for --respawn to resume rather than restart "
                   "from scratch)")
    p.add_argument("--crash-robot", type=int, default=-1,
                   help="FAULT INJECTION: which robot crashes (tcp tests)")
    p.add_argument("--crash-after", type=int, default=0,
                   help="FAULT INJECTION: crash after N fed frames")
    args = p.parse_args(argv)

    if args.transport == "tcp":
        if args.fleet:
            p.error("--fleet is a single-process serving mode; it has no "
                    "tcp transport (drop --transport tcp)")
        return _run_tcp(args)

    from .utils import platform

    platform.select(args.platform)

    import jax.numpy as jnp

    from .geometry import se3
    from .runtime import Mapper
    from .runtime.transport import LocalBus

    R = args.robots
    get_scan, get_pose, n = build_dataset(args)
    splits = make_splits(n, R, args.overlap)

    if args.fleet:
        from .runtime import FleetMapper

        fleet = FleetMapper(make_cfg(args, 0))
        t0 = time.perf_counter()
        inter_loops = intra_loops = 0
        for step in range(max(len(s) for s in splits)):
            for r in range(R):
                if step >= len(splits[r]):
                    continue
                k = splits[r][step]
                T = get_pose(k)
                pose = se3.Pose(
                    jnp.asarray(T[:3, :3], jnp.float32),
                    jnp.asarray(T[:3, 3], jnp.float32),
                )
                fleet.add_robot_frame(r, pose, get_scan(k), stamp=0.1 * k)
            for ev in fleet.step():
                intra_loops += "loop" in ev
                inter_loops += "inter_loop" in ev
            fleet.spin()
        fleet.optimize()
        wall = time.perf_counter() - t0
        mapper0 = fleet  # reporting reads robot 0's (joint) view
    else:
        bus = LocalBus()
        mappers = []
        for r in range(R):
            m = Mapper(make_cfg(args, r))
            m.attach_bus(bus)
            mappers.append(m)

        t0 = time.perf_counter()
        inter_loops = intra_loops = 0
        for step in range(max(len(s) for s in splits)):
            for r in range(R):
                if step >= len(splits[r]):
                    continue
                k = splits[r][step]
                T = get_pose(k)
                pose = se3.Pose(
                    jnp.asarray(T[:3, :3], jnp.float32),
                    jnp.asarray(T[:3, 3], jnp.float32),
                )
                wire = mappers[r].add_frame(pose, get_scan(k), stamp=0.1 * k)
                if wire is not None:
                    mappers[r].broadcast_latest(wire)
                    info = mappers[r].spin_once()
                    if info.get("loop"):
                        intra_loops += 1
                    if info.get("inter_loop"):
                        inter_loops += 1
        for m in mappers:
            m.optimize()
        wall = time.perf_counter() - t0
        mapper0 = mappers[0]

    mapper0.save_trajectories(args.output)
    report = {
        "robots": R,
        "mode": "fleet" if args.fleet else "decentralized",
        "frames": n,
        "intra_loops": intra_loops,
        "inter_loops": inter_loops,
        "wall_s": round(wall, 2),
        "frames_per_s": round(n / wall, 2),
        "output": args.output,
    }
    report.update(report_view(mapper0, get_pose, R, args.output))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

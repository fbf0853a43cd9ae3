"""Per-robot worker process for ``run_multi --transport tcp``.

One process = one robot's Mapper over a real socket transport
(``runtime/transport.py::TcpBus``) — the process-per-robot deployment
shape the reference runs over TCPROS (one ROS node per robot,
``src/distributedMapping.cpp``). Spawned by ``run_multi``; can also be
launched by hand on N machines (point ``--ports`` at the peers).

Choreography (sentinel files in ``--workdir``, the pattern proven by
``tests/tcpbus_worker.py``):

- ``ready_<r>``: listener up. Everyone waits for all before feeding, so
  no descriptor broadcast is lost (the in-order peer-chain protocol
  drops anything after a gap).
- ``fed_<r>``: robot r finished feeding. Feeding is SERIAL by robot id:
  robot r waits for ``fed_<r-1>`` — descriptor ingestion happens on the
  bus thread while the main thread is idle in the wait (the
  thread-safety envelope the transport is tested under), and later
  robots then close inter-robot loops against every earlier robot's
  full stream, with verification RPCs crossing the sockets to the
  idle-serving earlier workers.
- after ``fed_<R-1>`` (all feeding done, hence no more RPCs in flight)
  every worker optimizes and writes ``out_<r>``; robot 0's out carries
  the joint view (ATEs + figure), matching the in-process report.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _wait_for(path: str, timeout: float) -> None:
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"timed out waiting for {path}")
        time.sleep(0.1)


def _publish(wd: str, name: str, content: str = "") -> None:
    """Write a sentinel file atomically (tmp + rename): waiters key on
    existence, so the content — e.g. the worker's bound port — must be
    complete the instant the file appears."""
    tmp = os.path.join(wd, f".{name}.tmp")
    with open(tmp, "w") as f:
        f.write(content)
    os.replace(tmp, os.path.join(wd, name))


def main(argv=None):
    from .run_multi import (
        add_dataset_args, build_dataset, make_cfg, make_splits, report_view,
    )

    p = argparse.ArgumentParser(description="scl_slam per-robot worker")
    add_dataset_args(p)
    p.add_argument("--robot", type=int, required=True)
    p.add_argument("--ports", required=True,
                   help="comma-separated listen ports, one per robot, or "
                   "'auto': each worker binds an OS-assigned port and "
                   "publishes it via its ready_<r> sentinel (no reserve-"
                   "then-rebind TOCTOU window; single-machine runs only)")
    p.add_argument("--workdir", required=True,
                   help="shared dir for the barrier sentinel files")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint (runtime/checkpoint.py, atomic) every N "
                   "fed frames to <workdir>/ckpt_<r>.npz; 0 disables")
    p.add_argument("--resume", action="store_true",
                   help="restore <workdir>/ckpt_<r>.npz if present and skip "
                   "the frames already fed — the respawn path (reference "
                   "launch respawn=\"true\", single_ugv.launch:4)")
    p.add_argument("--crash-after", type=int, default=0,
                   help="FAULT INJECTION (respawn tests): hard-exit rc=3 "
                   "after feeding N frames; ignored under --resume")
    args = p.parse_args(argv)

    from .utils import platform

    platform.select(args.platform)

    import jax.numpy as jnp
    import numpy as np

    from .geometry import se3
    from .runtime import Mapper
    from .runtime.transport import TcpBus

    r = args.robot
    R = args.robots

    get_scan, get_pose, n = build_dataset(args)
    splits = make_splits(n, R, args.overlap)

    if args.ports == "auto":
        # bind an OS-assigned port and publish it through the ready
        # sentinel; peers are learned from everyone else's sentinels at
        # the ready barrier (before any broadcast can happen)
        bus = TcpBus(r, 0, {})
    else:
        ports = [int(x) for x in args.ports.split(",")]
        assert len(ports) == R
        bus = TcpBus(r, ports[r], {
            q: ("127.0.0.1", ports[q]) for q in range(R)
        })
    mapper = Mapper(make_cfg(args, r))
    mapper.attach_bus(bus)

    wd = args.workdir
    ckpt_path = os.path.join(wd, f"ckpt_{r}.npz")
    counters_path = os.path.join(wd, f"ckpt_counters_{r}")
    start_at = 0
    intra = inter = 0
    if args.resume and os.path.exists(ckpt_path):
        from .runtime import checkpoint

        checkpoint.load(mapper, ckpt_path)
        # _frames_seen counts this robot's own fed frames (peer ingests
        # don't touch it), so it is exactly the resume cursor. Frames fed
        # after the checkpoint but before the crash are re-fed; peers
        # drop the replayed descriptor indices as out-of-order dupes.
        start_at = min(mapper._frames_seen, len(splits[r]))
        # loop counters are report-side state, not Mapper state: without
        # the sidecar a respawned worker would report only post-crash
        # loop closures (the map itself is unaffected)
        try:
            intra, inter = (
                int(x) for x in
                open(counters_path).read().split(",")
            )
        except (OSError, ValueError):
            pass
    # barriers scale with fleet size: a cold-cache first compile takes
    # minutes, and robot r waits behind r-1 robots' full feeds
    t_ready = 120.0 * max(1, R)
    t_feed = 900.0 * max(1, R)
    _publish(wd, f"ready_{r}", str(bus.port))
    for q in range(R):
        _wait_for(os.path.join(wd, f"ready_{q}"), t_ready)
    if args.ports == "auto":
        bus.peers = {
            q: ("127.0.0.1",
                int(open(os.path.join(wd, f"ready_{q}")).read()))
            for q in range(R)
        }
    if r > 0:
        _wait_for(os.path.join(wd, f"fed_{r - 1}"), t_feed)

    fed = 0
    for k in splits[r][start_at:]:
        T = get_pose(k)
        pose = se3.Pose(
            jnp.asarray(T[:3, :3], jnp.float32),
            jnp.asarray(T[:3, 3], jnp.float32),
        )
        wire = mapper.add_frame(pose, get_scan(k), stamp=0.1 * k)
        if wire is not None:
            mapper.broadcast_latest(wire)
            info = mapper.spin_once()
            intra += bool(info.get("loop"))
            inter += bool(info.get("inter_loop"))
        fed += 1
        if args.checkpoint_every and fed % args.checkpoint_every == 0:
            from .runtime import checkpoint

            checkpoint.save(mapper, ckpt_path)
            _publish(wd, f"ckpt_counters_{r}", f"{intra},{inter}")
        if args.crash_after and not args.resume and fed >= args.crash_after:
            os._exit(3)  # fault injection: simulated hard crash mid-feed
    _publish(wd, f"fed_{r}")

    # all feeding done everywhere => no verification RPC can still arrive
    _wait_for(os.path.join(wd, f"fed_{R - 1}"), t_feed)
    mapper.optimize()

    out = {"robot": r, "frames": n, "intra_loops": intra,
           "inter_loops": inter}
    if r == 0:
        os.makedirs(args.output, exist_ok=True)
        mapper.save_trajectories(args.output)
        out["ate_rmse_m"] = {}
        out.update(report_view(mapper, get_pose, R, args.output))
    out["counts"] = [int(c) for c in np.asarray(mapper.state.counts)[:R]]
    with open(os.path.join(wd, f"out_{r}"), "w") as f:
        json.dump(out, f)
    bus.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

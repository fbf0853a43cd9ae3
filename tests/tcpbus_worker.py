"""Worker process for the cross-process TcpBus test (test_transport.py).

Runs ONE robot's Mapper with a real socket transport — the process-per-
robot deployment shape the reference runs over TCPROS. Coordination with
the peer process is via sentinel files in the shared tmp directory:

  <dir>/ready_<rid>   listener up (written after attach_bus)
  <dir>/fed_0         robot 0 finished feeding + broadcasting its frames
  <dir>/done_1        robot 1 finished (robot 0 may exit)

Robot 0 feeds first (broadcasting each keyframe), then stays alive to
serve verification RPCs; robot 1 ingests the stream as it arrives, then
feeds its own frames, running inter-robot detection whose RANSAC
verification crosses the socket to robot 0. Results go to <dir>/out_<rid>
as one JSON line.
"""
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from scl_slam.geometry import se3
from scl_slam.io import kitti
from scl_slam.runtime import Mapper
from scl_slam.runtime.transport import TcpBus

from test_multi_robot import robot_cfg  # noqa: E402  (same tuned config)


def wait_for(path, timeout=240.0):
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"timed out waiting for {path}")
        time.sleep(0.1)


def main():
    rid = int(sys.argv[1])
    my_port = int(sys.argv[2])
    peer_port = int(sys.argv[3])
    workdir = sys.argv[4]

    world = kitti.SyntheticWorld(
        seed=5, extent=100.0, n_clusters=70, pts_per_cluster=800
    )
    gt = kitti.loop_trajectory(n_frames=64, radius=35.0, revisit=False)
    split = [list(range(0, 40)), list(range(32, 64))]

    peers = {0: ("127.0.0.1", my_port if rid == 0 else peer_port),
             1: ("127.0.0.1", my_port if rid == 1 else peer_port)}
    bus = TcpBus(rid, my_port, peers)
    m = Mapper(robot_cfg(rid))
    m.attach_bus(bus)
    open(os.path.join(workdir, f"ready_{rid}"), "w").close()
    wait_for(os.path.join(workdir, f"ready_{1 - rid}"))

    if rid == 1:
        # let robot 0's whole stream land first (in-order over the
        # persistent descriptor connection)
        wait_for(os.path.join(workdir, "fed_0"))

    inter_loops = 0
    for k in split[rid]:
        scan = world.scan_at(gt[k], max_points=4096, seed=k)
        pose = se3.Pose(
            jnp.asarray(gt[k][:3, :3], jnp.float32),
            jnp.asarray(gt[k][:3, 3], jnp.float32),
        )
        wire = m.add_frame(pose, scan, stamp=0.1 * k)
        if wire is not None:
            m.broadcast_latest(wire)
            info = m.spin_once()
            if info.get("inter_loop"):
                inter_loops += 1

    if rid == 0:
        open(os.path.join(workdir, "fed_0"), "w").close()
        # serve robot 1's verification RPCs until it finishes
        wait_for(os.path.join(workdir, "done_1"))

    m.optimize()
    out = {
        "rid": rid,
        "counts": [int(c) for c in np.asarray(m.state.counts)],
        "inter_loops": inter_loops,
        "traj_finite": bool(np.isfinite(m.trajectory(robot=rid)).all()),
    }
    with open(os.path.join(workdir, f"out_{rid}"), "w") as f:
        json.dump(out, f)
    if rid == 1:
        open(os.path.join(workdir, "done_1"), "w").close()
    bus.close()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

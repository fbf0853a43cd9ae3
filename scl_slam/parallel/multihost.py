"""Multi-host initialization and mesh construction.

The reference's multi-machine story is ROS networking (one roscore, TCPROS
across robots). Here: ``jax.distributed`` — one process per
host, XLA collectives between the devices of a host and across hosts
(SURVEY §2.3). These helpers wrap initialization and the standard mesh
layouts used by :mod:`.sharded`.

Typical pod usage (same binary on every host):

    from scl_slam.parallel import multihost
    multihost.init(coordinator="10.0.0.1:8476", num_processes=4, process_id=H)
    mesh = multihost.make_mesh(("shard",))
    # factor-sharded solves and row-sharded retrieval now span all hosts
"""
from __future__ import annotations

import numpy as np


def init(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed (no-op when single-process / already up)."""
    import jax

    if num_processes in (None, 1):
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" not in str(e):
            raise


def make_mesh(axis_names=("shard",), devices=None):
    """Mesh over all global devices (multi-host aware).

    1-D by default — the factor-sharded solver and row-sharded retrieval
    need one axis. For hybrid layouts pass e.g. ``axis_names=("host", "chip")``
    with a matching 2-D device array.
    """
    import jax
    from jax.sharding import Mesh

    devs = np.array(devices if devices is not None else jax.devices())
    if len(axis_names) == 1:
        return Mesh(devs, axis_names)
    # hosts x local-chips layout
    n_proc = jax.process_count()
    local = len(devs) // n_proc
    return Mesh(devs.reshape(n_proc, local), axis_names)


def robot_shard_bounds(num_robots: int, max_keyframes: int, num_shards: int):
    """Static (start, end) global-slot ranges assigning keyframe blocks to

    shards — the pose-graph partitioning of SURVEY §2.3 (keyframe blocks per
    host subsume per-robot subgraphs)."""
    total = num_robots * max_keyframes
    per = total // num_shards
    return [(s * per, (s + 1) * per if s < num_shards - 1 else total)
            for s in range(num_shards)]

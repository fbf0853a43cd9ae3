"""Device-resident SLAM state: keyframe DB, descriptor DB, factor graph.

The functional replacement for the reference's mutable per-robot state
(``struct singleRobot`` + ``cloudKeyPoses3D/6D`` + ``keyFrameArray``,
reference ``include/distributedMapping.h:57-96, 727-748``). All arrays are
fixed-capacity; keyframe slots are global: robot r, local index i ->
slot r * max_keyframes + i (the analog of GTSAM ``Symbol('a'+r, i)``).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..descriptors import base as desc_base
from ..descriptors import scan_context as sc
from ..geometry import se3
from ..graph import factors as F


class LoopQueue(NamedTuple):
    """Pending verified loop factors (reference ``loopInfoQueue``,

    ``include/distributedMapping.h:784-823``)."""

    i: jax.Array          # [Q] int32 global slot
    j: jax.Array          # [Q]
    z_R: jax.Array        # [Q, 3, 3]
    z_t: jax.Array        # [Q, 3]
    noise: jax.Array      # [Q] scalar noise (ICP fitness), ref :1146-1159
    count: jax.Array      # scalar


class MapperState(NamedTuple):
    # keyframe DB
    kf_xyz: jax.Array       # [S, P*3] downsampled keyframe clouds, flattened
    #                         interleaved (x0,y0,z0,x1,...): a [S, P, 3] array
    #                         as a scan carry pads its minor dim of 3 in
    #                         tiled device layouts; the flat form does not
    kf_mask: jax.Array      # [S, P] bool
    odom_R: jax.Array       # [S, 3, 3] odometry-frame poses (as received)
    odom_t: jax.Array       # [S, 3]
    opt_R: jax.Array        # [S, 3, 3] optimized map-frame poses
    opt_t: jax.Array        # [S, 3]
    stamps: jax.Array       # [S] float64-ish seconds (f32)
    counts: jax.Array       # [R] per-robot keyframe counts

    # descriptor DB (family-specific descriptor + key arrays)
    desc_db: desc_base.DescriptorDB

    # factor graph over global slots
    graph: F.FactorGraph

    # loop bookkeeping
    loop_target: jax.Array  # [S] int32: accepted loop partner slot or -1 (dedup,
    #                         the reference's loopIndexContainer, :1088-1093)
    loop_queue: LoopQueue
    loop_closed: jax.Array  # bool: a loop was accepted since last optimize

    @property
    def max_keyframes(self) -> int:
        return self.kf_xyz.shape[0] // self.counts.shape[0]

    def slot(self, robot, index):
        return robot * self.max_keyframes + index

    def opt_poses(self) -> se3.Pose:
        return se3.Pose(self.opt_R, self.opt_t)


def _family_db(cfg: SlamConfig, capacity: int):
    from ..descriptors import registry

    return registry.get_family(cfg).make_db(capacity)


def make_state(cfg: SlamConfig) -> MapperState:
    R = cfg.number_of_robots
    K = cfg.keyframe.max_keyframes
    P = cfg.keyframe.points_per_keyframe
    S = R * K
    Q = cfg.loop.queue_capacity
    # distinct buffers per field (donation rejects aliased inputs)
    def eye():
        return jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (S, 1, 1))

    return MapperState(
        kf_xyz=jnp.full((S, P * 3), 1e6, jnp.float32),
        kf_mask=jnp.zeros((S, P), bool),
        odom_R=eye(),
        odom_t=jnp.zeros((S, 3), jnp.float32),
        opt_R=eye(),
        opt_t=jnp.zeros((S, 3), jnp.float32),
        stamps=jnp.zeros((S,), jnp.float32),
        counts=jnp.zeros((R,), jnp.int32),
        desc_db=_family_db(cfg, S),
        graph=F.make_graph(cfg.optimizer.edge_capacity, cfg.optimizer.prior_capacity),
        loop_target=jnp.full((S,), -1, jnp.int32),
        loop_queue=LoopQueue(
            i=jnp.zeros(Q, jnp.int32),
            j=jnp.zeros(Q, jnp.int32),
            z_R=jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (Q, 1, 1)),
            z_t=jnp.zeros((Q, 3), jnp.float32),
            noise=jnp.zeros(Q, jnp.float32),
            count=jnp.zeros((), jnp.int32),
        ),
        loop_closed=jnp.array(False),
    )


def scan_context_config(cfg: SlamConfig) -> sc.ScanContextConfig:
    p = cfg.scan_context
    return sc.ScanContextConfig(
        num_rings=p.num_rings,
        num_sectors=p.num_sectors,
        max_radius=p.max_radius,
        lidar_height=p.lidar_height,
        num_candidates=p.num_candidates,
        exclude_recent=p.exclude_recent,
        distance_threshold=p.distance_threshold,
        max_bin_points=p.max_bin_points,
    )

"""Three-robot collaboration (the reference's seq-05/09 3-way splits)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from scl_slam.config import (
    KeyframeConfig,
    LoopConfig,
    OptimizerConfig,
    ScanContextParams,
    SlamConfig,
)
from scl_slam.geometry import se3
from scl_slam.io import kitti, trajectory as tio
from scl_slam.runtime import Mapper
from scl_slam.runtime.transport import LocalBus


def cfg_for(rid):
    return SlamConfig(
        number_of_robots=3,
        robot_id=rid,
        robot_name=chr(ord("a") + rid),
        keyframe=KeyframeConfig(
            max_keyframes=48, points_per_keyframe=2048, raw_points_capacity=4096,
            distance_threshold=2.0, descript_leaf_size=0.3,
        ),
        loop=LoopConfig(
            near_keyframes=3, submap_capacity=8192, icp_iterations=15,
            history_fitness_score=8.0, ransac_inlier_ratio=0.3,
            ransac_outlier_threshold=1.0,
        ),
        optimizer=OptimizerConfig(edge_capacity=512, gn_iters=5, cg_iters=32),
        scan_context=ScanContextParams(
            exclude_recent=8, num_candidates=6, distance_threshold=0.25
        ),
    )


def test_three_robot_joint_map():
    world = kitti.SyntheticWorld(
        seed=13, extent=90.0, n_clusters=60, pts_per_cluster=800
    )
    gt = kitti.loop_trajectory(n_frames=72, radius=30.0, revisit=False)
    # three overlapping thirds
    splits = [
        list(range(0, 30)),
        list(range(22, 52)),
        list(range(44, 72)),
    ]
    bus = LocalBus()
    mappers = [Mapper(cfg_for(r)) for r in range(3)]
    for m in mappers:
        m.attach_bus(bus)

    inter = 0
    for step in range(max(len(s) for s in splits)):
        for rid, frames in enumerate(splits):
            if step >= len(frames):
                continue
            k = frames[step]
            pose = se3.Pose(
                jnp.asarray(gt[k][:3, :3], jnp.float32),
                jnp.asarray(gt[k][:3, 3], jnp.float32),
            )
            wire = mappers[rid].add_frame(
                pose, world.scan_at(gt[k], max_points=4096, seed=k), stamp=0.1 * k
            )
            if wire is not None:
                mappers[rid].broadcast_latest(wire)
                info = mappers[rid].spin_once()
                if info.get("inter_loop"):
                    inter += 1
    for m in mappers:
        m.optimize()

    assert inter >= 2, "adjacent splits must close cross-robot loops"
    # every robot mirrors all three trajectories consistently with gt
    for viewer in range(3):
        for r in range(3):
            est = mappers[viewer].trajectory(robot=r)
            if len(est) < 3:
                continue
            stamps = mappers[viewer].keyframe_stamps(robot=r)
            ids = [int(round(float(s) / 0.1)) for s in stamps]
            ate = tio.ate_rmse(est, np.stack([gt[k] for k in ids]))
            assert ate < 1.0, f"viewer {viewer} sees robot {r} at ATE {ate}"

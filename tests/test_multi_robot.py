"""Two-robot collaborative mapping over the in-process bus.

The analog of the reference's 2-way KITTI bag split
(``launch/test_distributed_loop.launch:41-44``): both robots survey
overlapping arcs of the same world, exchange descriptors, verify
cross-robot loops over the RPC, and jointly optimize.
"""
import dataclasses

import jax
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


def robot_cfg(rid):
    return SlamConfig(
        number_of_robots=2,
        robot_id=rid,
        robot_name=chr(ord("a") + rid),
        keyframe=KeyframeConfig(
            max_keyframes=64,
            points_per_keyframe=2048,
            raw_points_capacity=4096,
            distance_threshold=2.0,
            descript_leaf_size=0.3,
        ),
        loop=LoopConfig(
            near_keyframes=4,
            submap_capacity=8192,
            icp_iterations=20,
            history_fitness_score=8.0,
            ransac_inlier_ratio=0.3,
            ransac_outlier_threshold=1.0,
        ),
        optimizer=OptimizerConfig(edge_capacity=512, gn_iters=6, cg_iters=48),
        scan_context=ScanContextParams(exclude_recent=10, num_candidates=6),
    )


@pytest.fixture(scope="module")
def two_robot_run():
    world = kitti.SyntheticWorld(
        seed=5, extent=100.0, n_clusters=70, pts_per_cluster=800
    )
    # both robots drive the same circle, robot b starts half a revolution in:
    # their arcs overlap everywhere -> plenty of inter-robot loop chances
    gt = kitti.loop_trajectory(n_frames=80, radius=35.0, revisit=False)
    split = [list(range(0, 48)), list(range(40, 80))]

    bus = LocalBus()
    mappers = [Mapper(robot_cfg(0)), Mapper(robot_cfg(1))]
    for m in mappers:
        m.attach_bus(bus)

    inter_loops = []
    # interleave the two robots frame by frame (bag replay analog)
    for step in range(max(len(s) for s in split)):
        for rid, frames in enumerate(split):
            if step >= len(frames):
                continue
            k = frames[step]
            scan = world.scan_at(gt[k], max_points=4096, seed=k)
            pose = se3.Pose(
                jnp.asarray(gt[k][:3, :3], jnp.float32),
                jnp.asarray(gt[k][:3, 3], jnp.float32),
            )
            wire = mappers[rid].add_frame(pose, scan, stamp=0.1 * k)
            if wire is not None:
                mappers[rid].broadcast_latest(wire)
                info = mappers[rid].spin_once()
                if info.get("inter_loop"):
                    inter_loops.append((rid, info["inter_loop"]))
    for m in mappers:
        m.optimize()
    return world, gt, split, mappers, inter_loops


class TestTwoRobots:
    def test_descriptors_exchanged(self, two_robot_run):
        _, _, split, mappers, _ = two_robot_run
        # each mapper's DB holds both robots' keyframes
        for m in mappers:
            assert int(m.state.counts[0]) > 10
            assert int(m.state.counts[1]) > 10

    def test_inter_loops_found(self, two_robot_run):
        _, _, _, _, inter_loops = two_robot_run
        assert len(inter_loops) >= 1

    def test_joint_trajectories_consistent(self, two_robot_run):
        world, gt, split, mappers, _ = two_robot_run
        # robot a's view of robot b's trajectory must match gt after the
        # joint solve (both fed gt odometry here, so ATE ~ small)
        m = mappers[0]
        est_b = m.trajectory(robot=1)
        stamps_b = m.keyframe_stamps(robot=1)
        gt_b = np.stack([gt[int(round(float(s) / 0.1))] for s in stamps_b])
        ate = tio.ate_rmse(est_b, gt_b)
        assert ate < 1.0

    def test_inter_loops_correct_peer_drift(self):
        """Robot b drifts; cross-robot loops + joint optimize must shrink its

        error below dead reckoning — the collaborative-mapping payoff."""
        import jax

        world = kitti.SyntheticWorld(
            seed=9, extent=100.0, n_clusters=70, pts_per_cluster=800
        )
        gt = kitti.loop_trajectory(n_frames=64, radius=32.0, revisit=False)
        split = [list(range(0, 40)), list(range(28, 64))]

        bus = LocalBus()
        cfg0, cfg1 = robot_cfg(0), robot_cfg(1)
        cfg1 = dataclasses.replace(
            cfg1,
            optimizer=dataclasses.replace(
                cfg1.optimizer,
                odometry_sigmas=(0.005,) * 3 + (0.05,) * 3,
                loop_noise_scale=0.05,
            ),
        )
        cfg0 = dataclasses.replace(cfg0, optimizer=cfg1.optimizer)
        mappers = [Mapper(cfg0), Mapper(cfg1)]
        for m in mappers:
            m.attach_bus(bus)

        # robot b's odometry drifts forward
        drift = se3.exp(jnp.array([0, 0, 0.001, 0.05, 0.0, 0.0]))
        b_poses = {}
        prev = None
        for k in split[1]:
            cur_gt = se3.Pose(
                jnp.asarray(gt[k][:3, :3], jnp.float32),
                jnp.asarray(gt[k][:3, 3], jnp.float32),
            )
            if prev is None:
                b_poses[k] = cur_gt
            else:
                inc_np = np.linalg.inv(gt[k - 1]) @ gt[k]
                inc = se3.Pose(
                    jnp.asarray(inc_np[:3, :3], jnp.float32),
                    jnp.asarray(inc_np[:3, 3], jnp.float32),
                )
                b_poses[k] = se3.compose(b_poses[k - 1], se3.compose(inc, drift))
            prev = k

        n_inter = 0
        for step in range(max(len(s) for s in split)):
            for rid, frames in enumerate(split):
                if step >= len(frames):
                    continue
                k = frames[step]
                scan = world.scan_at(gt[k], max_points=4096, seed=k)
                if rid == 0:
                    pose = se3.Pose(
                        jnp.asarray(gt[k][:3, :3], jnp.float32),
                        jnp.asarray(gt[k][:3, 3], jnp.float32),
                    )
                else:
                    pose = b_poses[k]
                wire = mappers[rid].add_frame(pose, scan, stamp=0.1 * k)
                if wire is not None:
                    mappers[rid].broadcast_latest(wire)
                    info = mappers[rid].spin_once()
                    if info.get("inter_loop"):
                        n_inter += 1
        for m in mappers:
            m.optimize()

        assert n_inter >= 1, "overlapping arcs must produce inter-robot loops"
        # robot b's own optimized trajectory vs gt, compared to dead reckoning
        est_b = mappers[1].trajectory(robot=1)
        stamps_b = mappers[1].keyframe_stamps(robot=1)
        frame_ids = [int(round(float(s) / 0.1)) for s in stamps_b]
        gt_b = np.stack([gt[k] for k in frame_ids])
        dead_b = np.stack(
            [np.asarray(se3.to_matrix(b_poses[k])) for k in frame_ids]
        )
        ate_opt = tio.ate_rmse(est_b, gt_b)
        ate_dead = tio.ate_rmse(dead_b, gt_b)
        # loops only anchor the overlap region (b's early, low-drift frames);
        # the guarantee is improvement + cross-robot consistency, not a fix
        # of unobserved segments
        assert ate_opt < ate_dead, (
            f"inter-robot loops must reduce b's ATE: {ate_opt} vs {ate_dead}"
        )
        # both robots' joint solves must agree on b's trajectory
        est_b_from_a = mappers[0].trajectory(robot=1)
        ate_b_from_a = tio.ate_rmse(est_b_from_a, gt_b)
        assert abs(ate_b_from_a - ate_opt) < 0.2, (
            f"views diverge: a sees {ate_b_from_a}, b sees {ate_opt}"
        )
        # server-side factor sharing: b's graph must hold the verified loops
        assert len(mappers[1].loop_constraints()) >= n_inter // 2

    def test_out_of_order_descriptor_dropped(self):
        m = Mapper(robot_cfg(0))
        wire = np.zeros(20 * 60, np.float32)
        ident = se3.identity()
        assert not m.ingest_peer_descriptor(1, 5, ident, ident, wire)
        assert m.ingest_peer_descriptor(1, 0, ident, ident, wire)
        assert int(m.state.counts[1]) == 1

    def test_inter_detect_freshness_gate(self, monkeypatch):
        """detect_inter_loop dispatches the device query only when
        something could change its outcome: a new own keyframe, a new
        peer descriptor, OR a previous found-but-failed verification
        (the RPC is randomized, so borderline matches keep their
        retry-per-spin semantics). The pure-idle case — no candidates,
        nothing new — must not re-dispatch (dispatch-floor waste at
        serving cadence)."""
        import scl_slam.runtime.mapper as mp

        bus = LocalBus()
        mappers = [Mapper(robot_cfg(0)), Mapper(robot_cfg(1))]
        for m in mappers:
            m.attach_bus(bus)
        calls = [0]
        real = mp._detect_inter

        def counting(*a, **k):
            calls[0] += 1
            return real(*a, **k)

        monkeypatch.setattr(mp, "_detect_inter", counting)
        rng = np.random.default_rng(0)
        scan = rng.normal(size=(512, 3)).astype(np.float32) * 5.0
        mappers[0].add_frame(se3.identity(), scan, stamp=0.0)
        assert mappers[0].detect_inter_loop() is None  # empty peer DB
        assert calls[0] == 1
        # unchanged inputs, no candidate: no re-dispatch
        for _ in range(3):
            assert mappers[0].detect_inter_loop() is None
        assert calls[0] == 1
        # a peer descriptor re-arms the query; the zeros-wire candidate
        # is retrieved but fails geometric verification, which RE-ARMS
        # the gate (randomized RANSAC deserves a retry) — so every spin
        # retries until the candidate stops matching or verifies
        wire = np.zeros(20 * 60, np.float32)
        assert mappers[0].ingest_peer_descriptor(
            1, 0, se3.identity(), se3.identity(), wire
        )
        assert mappers[0].detect_inter_loop() is None  # verify fails
        assert calls[0] == 2
        assert mappers[0]._inter_dirty  # re-armed by the failed verify
        mappers[0].detect_inter_loop()
        assert calls[0] == 3
        # a new own keyframe also re-arms
        mappers[0]._inter_dirty = False  # silence the retry loop
        mappers[0].detect_inter_loop()
        assert calls[0] == 3
        far = se3.Pose(jnp.eye(3), jnp.asarray([10.0, 0.0, 0.0]))
        mappers[0].add_frame(far, scan + np.float32([10.0, 0.0, 0.0]), stamp=0.1)
        mappers[0].detect_inter_loop()
        assert calls[0] == 4

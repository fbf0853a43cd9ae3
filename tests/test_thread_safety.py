"""Mapper state-mutation thread safety (the TcpBus bus-thread envelope).

With a socket transport, peer descriptors are ingested on the bus's
connection-handler thread while the main thread runs add_frame/spin_once/
optimize. Before the r4 state lock, both did unlocked read-modify-writes
of ``mapper.state`` and one update could be silently lost. This hammers
exactly that interleaving in-process.
"""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np

from scl_slam.config import KeyframeConfig, LoopConfig, SlamConfig
from scl_slam.geometry import se3
from scl_slam.io import kitti as kio
from scl_slam.runtime import Mapper
from scl_slam.runtime.transport import VerifyRequest


def _cfg(robot):
    return dataclasses.replace(
        SlamConfig(),
        number_of_robots=2,
        robot_id=robot,
        robot_name=chr(ord("a") + robot),
        keyframe=KeyframeConfig(
            distance_threshold=0.0, angle_threshold=0.0,
            raw_points_capacity=8192, points_per_keyframe=2048,
            max_keyframes=64,
        ),
    )


def test_concurrent_peer_ingest_no_lost_updates():
    m0, m1 = Mapper(_cfg(0)), Mapper(_cfg(1))
    world = kio.SyntheticWorld(seed=2, extent=80.0, pts_per_cluster=300)
    gt = kio.loop_trajectory(n_frames=16, radius=12.0)

    def pose_of(k):
        T = gt[k]
        return se3.Pose(
            jnp.asarray(T[:3, :3], jnp.float32),
            jnp.asarray(T[:3, 3], jnp.float32),
        )

    wires = []
    for k in range(16):
        w = m1.add_frame(
            pose_of(k), world.scan_at(gt[k], max_points=8192, seed=100 + k),
            stamp=0.1 * k,
        )
        if w is not None:
            wires.append((k, np.asarray(w)))
    assert len(wires) == 16

    errs = []

    def pusher():
        try:
            for i, (k, w) in enumerate(wires):
                pre = pose_of(wires[i - 1][0]) if i > 0 else pose_of(k)
                assert m0.ingest_peer_descriptor(
                    1, i, pre, pose_of(k), w, stamp=0.1 * k
                ), i
        except Exception as e:  # surface thread failures in the main test
            errs.append(e)

    th = threading.Thread(target=pusher)
    th.start()
    for k in range(16):
        m0.add_frame(
            pose_of(k), world.scan_at(gt[k], max_points=8192, seed=k),
            stamp=0.1 * k,
        )
    th.join()
    assert not errs, errs
    counts = np.asarray(m0.state.counts)[:2]
    # pre-lock, this nondeterministically read (16, <16) or (<16, 16)
    assert counts[0] == 16 and counts[1] == 16, counts


def test_concurrent_serve_verification_no_lost_updates():
    """The r4-verdict race: serve_verification runs on the bus thread WITHOUT
    the state lock (deliberately — a robot blocked in its own locked
    detect_inter_loop RPC must still serve peers). Before r5 it ended with an
    unlocked ``self.state = _queue_loop(...)`` write-back: serve reads state,
    RANSAC runs for a long window, the write-back then discards every locked
    main-thread ingest that landed in between. Now the serve path is
    genuinely read-only (pending factors buffered host-side, drained by the
    next locked entry point) — this hammers the old interleaving and checks
    both that no ingest is lost and that the server-side factor still reaches
    the device queue (reference adds the verified factor to BOTH robots'
    graphs, distributedMapping.h:1373-1374)."""
    cfg = dataclasses.replace(
        _cfg(0),
        loop=LoopConfig(
            near_keyframes=4,
            submap_capacity=4096,
            ransac_max_iter=64,
            ransac_inlier_ratio=0.2,
            ransac_outlier_threshold=1.0,
        ),
    )
    m0 = Mapper(cfg)
    world = kio.SyntheticWorld(seed=7, extent=80.0, pts_per_cluster=400)
    gt = kio.loop_trajectory(n_frames=32, radius=14.0)

    def pose_of(k):
        T = gt[k]
        return se3.Pose(
            jnp.asarray(T[:3, :3], jnp.float32),
            jnp.asarray(T[:3, 3], jnp.float32),
        )

    for k in range(16):
        m0.add_frame(
            pose_of(k), world.scan_at(gt[k], max_points=8192, seed=k),
            stamp=0.1 * k,
        )

    # a request that verifies successfully against m0's own submap around
    # keyframe 5: the "peer's" cloud is a map-frame scan taken at gt[5]
    scan5 = world.scan_at(gt[5], max_points=2048, seed=500)
    map_frame = scan5 @ gt[5][:3, :3].T + gt[5][:3, 3]
    req = VerifyRequest(
        robot_cur=1,
        index_cur=7,
        robot_pre=0,
        index_pre=5,
        cloud_xyz=map_frame.astype(np.float32),
        cloud_mask=np.ones(len(map_frame), bool),
        cur_pose_est=gt[5].astype(np.float32),
    )
    resp = m0.serve_verification(req)
    assert resp.success, "sanity: the crafted request must verify"

    errs, successes = [], []

    def server():
        try:
            for _ in range(8):
                r = m0.serve_verification(req)
                successes.append(r.success)
        except Exception as e:
            errs.append(e)

    # widen the read->write window of any state write on the serve path:
    # _queue_loop's caller reads self.state when evaluating the argument; a
    # sleep before returning makes the old unlocked write-back lose a
    # concurrent ingest deterministically (verified: the pre-fix code fails
    # this test under the widened window). The fixed code only calls
    # _queue_loop under the state lock, so the sleep is harmless there.
    import time as _time
    from scl_slam.runtime import mapper as mapper_mod

    orig_queue_loop = mapper_mod._queue_loop

    def slow_queue_loop(state, *a, **kw):
        _time.sleep(0.05)
        return orig_queue_loop(state, *a, **kw)

    mapper_mod._queue_loop = slow_queue_loop
    try:
        th = threading.Thread(target=server)
        th.start()
        for k in range(16, 32):
            m0.add_frame(
                pose_of(k), world.scan_at(gt[k], max_points=8192, seed=k),
                stamp=0.1 * k,
            )
        th.join()
    finally:
        mapper_mod._queue_loop = orig_queue_loop
    assert not errs, errs
    assert all(successes), successes
    # pre-fix: serve's write-back clobbered concurrent ingests -> counts < 32
    assert int(m0.state.counts[0]) == 32, np.asarray(m0.state.counts)
    # serve must not have touched device state from the bus thread...
    m0.spin_once()
    # ...but after a locked entry point the buffered factor is queued
    # device-side (robot 1's endpoint is unknown here, so it stays deferred
    # in the queue rather than entering the graph — reference :790-795)
    assert int(m0.state.loop_queue.count) >= 1

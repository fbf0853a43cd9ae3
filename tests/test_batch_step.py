"""Macro-batched keyframe step must be semantically identical to the

sequential fused step (same state evolution, same detections)."""
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3
from scl_slam.runtime import mapper as M
from scl_slam.runtime.state import make_state

from test_checkpoint import tiny_cfg


def test_batch_equals_sequential():
    cfg = tiny_cfg()
    rng = np.random.RandomState(0)
    B = 6
    xyz = jnp.asarray(rng.uniform(-20, 20, (B, 512, 3)), jnp.float32)
    mask = jnp.ones((B, 512), bool)
    pose_R = jnp.broadcast_to(jnp.eye(3), (B, 3, 3))
    pose_t = jnp.stack([jnp.array([2.0 * k, 0.0, 0.0]) for k in range(B)])
    stamps = jnp.arange(B, dtype=jnp.float32) * 0.1

    # sequential fused path
    s1 = make_state(cfg)
    for k in range(B):
        s1, _, ok, match, fit = M._ingest_and_detect(
            s1, jnp.array(0), se3.Pose(pose_R[k], pose_t[k]),
            xyz[k], mask[k], stamps[k], cfg,
        )

    # batched path
    s2 = make_state(cfg)
    s2, oks, idxs, fits = M._ingest_and_detect_batch(
        s2, jnp.array(0), se3.Pose(pose_R, pose_t), xyz, mask, stamps, cfg
    )

    assert int(s2.counts[0]) == int(s1.counts[0]) == B
    np.testing.assert_allclose(np.asarray(s2.opt_t), np.asarray(s1.opt_t), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(s2.desc_db.keys), np.asarray(s1.desc_db.keys), atol=1e-6
    )
    assert int(s2.graph.num_edges) == int(s1.graph.num_edges)
    assert int(s2.loop_queue.count) == int(s1.loop_queue.count)


def test_batch_equals_sequential_with_loops():
    """Replay a revisiting trajectory so the batched ICP verification path
    actually fires, and require the same loop decisions as the sequential
    fused step (phase-2 historical-count submap gathers + per-lane
    convergence freezing make the batch path exact, not approximate)."""
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import small_cfg, drifting_odometry
    from scl_slam.io import kitti

    cfg = small_cfg()
    world = kitti.SyntheticWorld(
        seed=3, extent=120.0, n_clusters=80, pts_per_cluster=800
    )
    gt = kitti.loop_trajectory(n_frames=48, radius=40.0, revisit=True)
    odom = drifting_odometry(gt, [0.0] * 6)
    scans = [world.scan_at(gt[k], max_points=4096, seed=k) for k in range(len(gt))]

    def inputs(k):
        x = jnp.asarray(scans[k], jnp.float32)
        pad = cfg.keyframe.raw_points_capacity - x.shape[0]
        m = jnp.concatenate([jnp.ones(x.shape[0], bool), jnp.zeros(pad, bool)])
        x = jnp.concatenate([x, jnp.full((pad, 3), 1e6, jnp.float32)])
        return x, m

    s1 = make_state(cfg)
    fits1 = []
    for k in range(len(gt)):
        x, m = inputs(k)
        s1, _w, ok, match, fit = M._ingest_and_detect(
            s1, jnp.array(0), odom[k], x, m, jnp.float32(0.1 * k), cfg
        )
        fits1.append(float(fit))

    s2 = make_state(cfg)
    B = 8
    fits2 = []
    for k0 in range(0, len(gt), B):
        xs, ms = zip(*[inputs(k) for k in range(k0, k0 + B)])
        pR = jnp.stack([odom[k].R for k in range(k0, k0 + B)])
        pt = jnp.stack([odom[k].t for k in range(k0, k0 + B)])
        s2, oks, idxs, fits = M._ingest_and_detect_batch(
            s2, jnp.array(0), se3.Pose(pR, pt), jnp.stack(xs), jnp.stack(ms),
            jnp.arange(k0, k0 + B, dtype=jnp.float32) * 0.1, cfg,
        )
        fits2.extend(np.asarray(fits).tolist())

    n1, n2 = int(s1.loop_queue.count), int(s2.loop_queue.count)
    assert n1 > 0, "test sequence produced no loops; gate is meaningless"
    assert n2 == n1
    np.testing.assert_array_equal(
        np.asarray(s2.loop_queue.i[:n1]), np.asarray(s1.loop_queue.i[:n1])
    )
    np.testing.assert_array_equal(
        np.asarray(s2.loop_queue.j[:n1]), np.asarray(s1.loop_queue.j[:n1])
    )
    np.testing.assert_allclose(
        np.asarray(s2.loop_queue.z_t[:n1]),
        np.asarray(s1.loop_queue.z_t[:n1]),
        atol=5e-3,
    )
    f1 = np.asarray(fits1)
    f2 = np.asarray(fits2)
    both = np.isfinite(f1) & np.isfinite(f2)
    np.testing.assert_array_equal(np.isfinite(f1), np.isfinite(f2))
    np.testing.assert_allclose(f1[both], f2[both], rtol=5e-3, atol=1e-5)


def test_public_add_frames_equals_add_frame():
    """The public Mapper.add_frames replay API must produce the same state
    as sequential Mapper.add_frame: same keyframes (gate included), same
    loop queue, same trajectories."""
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import small_cfg, drifting_odometry
    from scl_slam.io import kitti
    from scl_slam.runtime.mapper import Mapper

    cfg = small_cfg()
    world = kitti.SyntheticWorld(
        seed=3, extent=120.0, n_clusters=80, pts_per_cluster=800
    )
    gt = kitti.loop_trajectory(n_frames=48, radius=40.0, revisit=True)
    odom = drifting_odometry(gt, [0.0] * 6)
    scans = [
        np.asarray(world.scan_at(gt[k], max_points=4096, seed=k))
        for k in range(len(gt))
    ]

    m1 = Mapper(cfg)
    for k in range(len(gt)):
        m1.add_frame(odom[k], scans[k], stamp=0.1 * k)

    m2 = Mapper(cfg)
    B = 8
    loops = []
    for k0 in range(0, len(gt), B):
        out = m2.add_frames(
            [odom[k] for k in range(k0, k0 + B)],
            scans[k0 : k0 + B],
            stamps=[0.1 * k for k in range(k0, k0 + B)],
        )
        assert all(out["accepted"])  # 1.5 m spacing passes the 1 m gate
        loops.extend(out["loops"])

    n1, n2 = int(m1.state.loop_queue.count), int(m2.state.loop_queue.count)
    assert n1 > 0, "revisit trajectory produced no loops; gate is meaningless"
    assert n2 == n1
    np.testing.assert_array_equal(
        np.asarray(m2.state.loop_queue.i[:n1]), np.asarray(m1.state.loop_queue.i[:n1])
    )
    assert sum(1 for l in loops if l) == n2
    assert int(m2.state.counts[0]) == int(m1.state.counts[0])
    np.testing.assert_allclose(
        np.asarray(m2.state.opt_t), np.asarray(m1.state.opt_t), atol=5e-3
    )

    # both solve to the same trajectory
    m1.optimize()
    m2.optimize()
    np.testing.assert_allclose(m2.trajectory(), m1.trajectory(), atol=5e-3)


def test_public_replay_equals_add_frames():
    """Mapper.replay (scanned chunks of R macro-batches in one program)
    must produce the same state and loop decisions as Mapper.add_frames,
    including the non-chunk remainder path."""
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import small_cfg, drifting_odometry
    from scl_slam.io import kitti
    from scl_slam.runtime.mapper import Mapper

    cfg = small_cfg()
    world = kitti.SyntheticWorld(
        seed=3, extent=120.0, n_clusters=80, pts_per_cluster=800
    )
    gt = kitti.loop_trajectory(n_frames=44, radius=40.0, revisit=True)
    odom = drifting_odometry(gt, [0.0] * 6)
    scans = [
        np.asarray(world.scan_at(gt[k], max_points=4096, seed=k))
        for k in range(len(gt))
    ]
    stamps = [0.1 * k for k in range(len(gt))]

    m1 = Mapper(cfg)
    loops1 = []
    for k0 in range(0, len(gt), 4):
        out = m1.add_frames(
            [odom[k] for k in range(k0, k0 + 4)],
            scans[k0 : k0 + 4],
            stamps=stamps[k0 : k0 + 4],
        )
        loops1.extend(out["loops"])

    # 44 frames = 2 chunks of (B=4 x R=4) + one 12-frame remainder batch
    m2 = Mapper(cfg)
    out = m2.replay(odom, scans, stamps=stamps, batch=4, chunk_batches=4)
    assert all(out["accepted"])
    assert m2._frames_seen == m1._frames_seen == len(gt)
    loops2 = out["loops"]

    n1, n2 = int(m1.state.loop_queue.count), int(m2.state.loop_queue.count)
    assert n1 > 0, "revisit trajectory produced no loops; gate is meaningless"
    assert n2 == n1
    np.testing.assert_array_equal(
        np.asarray(m2.state.loop_queue.i[:n1]),
        np.asarray(m1.state.loop_queue.i[:n1]),
    )
    assert [l is None for l in loops2] == [l is None for l in loops1]
    for a, b in zip(loops1, loops2):
        if a is not None:
            assert a["matched_index"] == b["matched_index"]
            np.testing.assert_allclose(
                a["fitness"], b["fitness"], rtol=5e-3, atol=1e-5
            )
    assert int(m2.state.counts[0]) == int(m1.state.counts[0])
    np.testing.assert_allclose(
        np.asarray(m2.state.opt_t), np.asarray(m1.state.opt_t), atol=5e-3
    )
    m1.optimize()
    m2.optimize()
    np.testing.assert_allclose(m2.trajectory(), m1.trajectory(), atol=5e-3)


def test_replay_int16_transfer_equals_f32():
    """transfer='int16' (5 mm fixed-point scan staging) must reproduce the
    f32 replay's loop decisions and trajectories to quantization noise —
    the wire format changes input BYTES, not pipeline semantics."""
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import small_cfg, drifting_odometry
    from scl_slam.io import kitti
    from scl_slam.runtime.mapper import Mapper

    cfg = small_cfg()
    world = kitti.SyntheticWorld(
        seed=3, extent=120.0, n_clusters=80, pts_per_cluster=800
    )
    gt = kitti.loop_trajectory(n_frames=44, radius=40.0, revisit=True)
    odom = drifting_odometry(gt, [0.0] * 6)
    scans = [
        np.asarray(world.scan_at(gt[k], max_points=4096, seed=k))
        for k in range(len(gt))
    ]
    stamps = [0.1 * k for k in range(len(gt))]

    outs, mappers = {}, {}
    for mode in ("f32", "int16"):
        m = Mapper(cfg)
        outs[mode] = m.replay(
            odom, scans, stamps=stamps, batch=4, chunk_batches=4,
            transfer=mode,
        )
        mappers[mode] = m

    a, b = outs["f32"]["loops"], outs["int16"]["loops"]
    assert sum(l is not None for l in a) > 0, "workload closed no loops"
    assert [l is None for l in a] == [l is None for l in b]
    for la, lb in zip(a, b):
        if la is not None:
            assert la["matched_index"] == lb["matched_index"]
            np.testing.assert_allclose(
                la["fitness"], lb["fitness"], rtol=0.05, atol=5e-3
            )
    for mode in mappers:
        mappers[mode].optimize()
    np.testing.assert_allclose(
        mappers["int16"].trajectory(), mappers["f32"].trajectory(),
        atol=2e-2,
    )

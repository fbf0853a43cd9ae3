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
from scl_slam.runtime import Mapper, checkpoint


def tiny_cfg():
    return SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=16, points_per_keyframe=256, raw_points_capacity=512
        ),
        loop=LoopConfig(near_keyframes=2, submap_capacity=512, queue_capacity=8),
        optimizer=OptimizerConfig(edge_capacity=64, gn_iters=2, cg_iters=8),
        scan_context=ScanContextParams(exclude_recent=2),
    )


def seeded_mapper(n=5):
    m = Mapper(tiny_cfg())
    rng = np.random.RandomState(0)
    for k in range(n):
        xyz = rng.uniform(-20, 20, (400, 3)).astype(np.float32)
        pose = se3.Pose(jnp.eye(3), jnp.array([2.0 * k, 0.0, 0.0]))
        m.add_frame(pose, xyz, stamp=0.1 * k)
    return m


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        m = seeded_mapper()
        path = str(tmp_path / "ckpt.npz")
        checkpoint.save(m, path)

        m2 = Mapper(tiny_cfg())
        checkpoint.load(m2, path)
        assert int(m2.state.counts[0]) == int(m.state.counts[0])
        np.testing.assert_array_equal(
            np.asarray(m2.state.opt_t), np.asarray(m.state.opt_t)
        )
        np.testing.assert_array_equal(
            np.asarray(m2.state.desc_db.keys), np.asarray(m.state.desc_db.keys)
        )
        assert m2._keyframes == m._keyframes

    def test_resume_continues_cleanly(self, tmp_path):
        m = seeded_mapper()
        path = str(tmp_path / "ckpt.npz")
        checkpoint.save(m, path)
        m2 = Mapper(tiny_cfg())
        checkpoint.load(m2, path)
        # add more frames to both; they must evolve identically
        rng = np.random.RandomState(7)
        for k in range(5, 8):
            xyz = rng.uniform(-20, 20, (400, 3)).astype(np.float32)
            pose = se3.Pose(jnp.eye(3), jnp.array([2.0 * k, 0.0, 0.0]))
            m.add_frame(pose, xyz.copy(), stamp=0.1 * k)
            m2.add_frame(pose, xyz.copy(), stamp=0.1 * k)
        np.testing.assert_array_equal(
            np.asarray(m2.state.opt_t), np.asarray(m.state.opt_t)
        )

    def test_shape_mismatch_rejected(self, tmp_path):
        m = seeded_mapper()
        path = str(tmp_path / "ckpt.npz")
        checkpoint.save(m, path)
        import dataclasses

        other = dataclasses.replace(
            tiny_cfg(), keyframe=KeyframeConfig(max_keyframes=32,
                                                points_per_keyframe=256,
                                                raw_points_capacity=512)
        )
        m3 = Mapper(other)
        with pytest.raises(ValueError, match="mismatch"):
            checkpoint.load(m3, path)

    def test_fleet_roundtrip_restores_gates(self, tmp_path):
        """FleetMapper checkpoints must carry the per-robot host-side
        keyframe gates (and RNG key): without them a restored session
        re-accepts a frame the gate had rejected."""
        import dataclasses

        from scl_slam.runtime import FleetMapper

        cfg = dataclasses.replace(tiny_cfg(), number_of_robots=2)
        fm = FleetMapper(cfg)
        rng = np.random.RandomState(1)
        for k in range(3):
            xyz = rng.uniform(-20, 20, (400, 3)).astype(np.float32)
            for r in (0, 1):
                pose = se3.Pose(jnp.eye(3), jnp.array([3.0 * k, 2.0 * r, 0.0]))
                assert fm.add_robot_frame(r, pose, xyz, stamp=0.1 * k)
            fm.step()
        path = str(tmp_path / "fleet.npz")
        checkpoint.save(fm, path)

        fm2 = checkpoint.load(FleetMapper(cfg), path)
        np.testing.assert_array_equal(
            np.asarray(fm2.state.counts), np.asarray(fm.state.counts)
        )
        np.testing.assert_array_equal(
            np.asarray(fm2._fleet_key), np.asarray(fm._fleet_key)
        )
        # same pose again: the restored gate must reject it for both robots
        xyz = rng.uniform(-20, 20, (400, 3)).astype(np.float32)
        for r in (0, 1):
            pose = se3.Pose(jnp.eye(3), jnp.array([6.0, 2.0 * r, 0.0]))
            assert not fm2.add_robot_frame(r, pose, xyz)
        # and a moved pose passes
        assert fm2.add_robot_frame(
            0, se3.Pose(jnp.eye(3), jnp.array([9.0, 0.0, 0.0])), xyz
        )
        assert len(fm2.step()) == 1

    def test_fleet_staged_frames_survive_checkpoint(self, tmp_path):
        """A checkpoint between add_robot_frame() and step() must carry the
        staged (gate-accepted, unprocessed) keyframes — the advanced gate
        would otherwise reject a re-feed and drop them permanently."""
        import dataclasses

        from scl_slam.runtime import FleetMapper

        cfg = dataclasses.replace(tiny_cfg(), number_of_robots=2)
        fm = FleetMapper(cfg)
        rng = np.random.RandomState(2)
        xyz = rng.uniform(-20, 20, (400, 3)).astype(np.float32)
        assert fm.add_robot_frame(
            0, se3.Pose(jnp.eye(3), jnp.zeros(3)), xyz, stamp=0.5
        )
        assert fm.add_robot_frame(
            1, se3.Pose(jnp.eye(3), jnp.array([0.0, 3.0, 0.0])), xyz,
            stamp=0.6,
        )
        path = str(tmp_path / "fleet_staged.npz")
        checkpoint.save(fm, path)

        fm2 = checkpoint.load(FleetMapper(cfg), path)
        assert len(fm2._fleet_staged) == 2
        events = fm2.step()
        assert len(events) == 2
        assert int(fm2.state.counts[0]) == 1 and int(fm2.state.counts[1]) == 1
        np.testing.assert_allclose(
            float(fm2.state.stamps[0]), 0.5, atol=1e-6
        )

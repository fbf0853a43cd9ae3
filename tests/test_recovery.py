"""Failure/recovery: mid-run crash + checkpoint resume must converge to the

same result as an uninterrupted run (the elastic-recovery story the
reference lacks — its only mechanism is launch-level respawn with total
state loss, SURVEY §5)."""
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3
from scl_slam.io import kitti
from scl_slam.runtime import Mapper, checkpoint

from test_checkpoint import tiny_cfg


def drive(m, world, gt, frames):
    for k in frames:
        scan = world.scan_at(gt[k], max_points=1024, seed=k)
        m.add_frame(
            se3.Pose(
                jnp.asarray(gt[k][:3, :3], jnp.float32),
                jnp.asarray(gt[k][:3, 3], jnp.float32),
            ),
            scan,
            stamp=0.1 * k,
        )
    return m


class TestCrashRecovery:
    def test_resume_equals_uninterrupted(self, tmp_path):
        world = kitti.SyntheticWorld(seed=2, extent=60.0, n_clusters=30)
        gt = kitti.loop_trajectory(n_frames=20, radius=18.0, revisit=False)

        # uninterrupted run
        m_full = drive(Mapper(tiny_cfg()), world, gt, range(20))

        # crash after 10 frames, checkpoint, "restart", resume
        m_a = drive(Mapper(tiny_cfg()), world, gt, range(10))
        ckpt = str(tmp_path / "crash.npz")
        checkpoint.save(m_a, ckpt)
        del m_a  # the crash
        m_b = Mapper(tiny_cfg())
        checkpoint.load(m_b, ckpt)
        m_b = drive(m_b, world, gt, range(10, 20))

        assert int(m_b.state.counts[0]) == int(m_full.state.counts[0])
        np.testing.assert_allclose(
            np.asarray(m_b.state.opt_t),
            np.asarray(m_full.state.opt_t),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(m_b.state.desc_db.keys),
            np.asarray(m_full.state.desc_db.keys),
            atol=1e-5,
        )

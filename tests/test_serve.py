"""Serving daemon: real socket round trips against an in-process server."""
import threading
import time

import numpy as np
import pytest

from scl_slam.serve import SlamClient, SlamServer

from test_checkpoint import tiny_cfg


@pytest.fixture()
def server():
    srv = SlamServer(tiny_cfg(), odometry="none", platform="cpu")
    t = threading.Thread(target=srv.serve, args=(7461,), daemon=True)
    t.start()
    time.sleep(0.3)
    yield srv
    srv._stop.set()
    t.join(timeout=3)


class TestServe:
    def test_frame_trajectory_save_stats(self, server, tmp_path):
        client = SlamClient(port=7461)
        rng = np.random.RandomState(0)
        try:
            for k in range(4):
                T = np.eye(4)
                T[0, 3] = 2.0 * k
                resp = client.frame(
                    rng.uniform(-20, 20, (400, 3)).astype(np.float32), T, stamp=0.1 * k
                )
                assert resp["keyframe"] is True
                np.testing.assert_allclose(resp["pose"][0, 3], 2.0 * k, atol=1e-4)
            traj = client.trajectory()
            assert traj["poses"].shape == (4, 4, 4)
            stats = client.stats()
            assert stats == {"frames": 4, "keyframes": 4, "loops": 0}
            out = client.save(str(tmp_path))
            assert out["ok"]
            assert (tmp_path / "a_tum.txt").exists()
            assert (tmp_path / "loop_constraints.json").exists()
        finally:
            client.close()

    def test_error_without_pose_or_odometry(self, server):
        client = SlamClient(port=7461)
        try:
            resp = client.frame(np.zeros((10, 3), np.float32), pose=None)
            assert "error" in resp
        finally:
            client.close()

"""KITTI odometry integration — runs only when a dataset is present.

Set SCL_SLAM_KITTI_ROOT to a KITTI odometry root (sequences/, poses/) to
enable. These are the real-data acceptance runs (reference bag-replay
analog); CI without data skips them.
"""
import os

import numpy as np
import pytest

KITTI_ROOT = os.environ.get("SCL_SLAM_KITTI_ROOT")

pytestmark = pytest.mark.skipif(
    not (KITTI_ROOT and os.path.isdir(KITTI_ROOT)),
    reason="KITTI dataset not available (set SCL_SLAM_KITTI_ROOT)",
)


class TestKitti:
    def test_sequence_reader(self):
        from scl_slam.io import kitti

        seq = kitti.KittiSequence(KITTI_ROOT, "00")
        assert len(seq) > 1000
        scan = seq.scan(0)
        assert scan.shape[1] == 3 and len(scan) > 50000
        T = seq.gt_pose_velo(0)
        assert T is None or T.shape == (4, 4)

    def test_short_run_ate(self):
        from scl_slam import run as cli

        rc = cli.main(
            [
                "--dataset", "kitti", "--root", KITTI_ROOT, "--sequence", "00",
                "--frames", "300", "--platform", "cpu",
                "--output", "/tmp/kitti_test_run",
            ]
        )
        assert rc == 0
        assert os.path.exists("/tmp/kitti_test_run/a_tum.txt")

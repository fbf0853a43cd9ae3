"""KITTI dataset-path format fidelity, no real data required.

`tests/test_kitti_integration.py` runs only when a real KITTI root exists
(none does in this environment), which left the production dataset path —
.bin reader, poses.txt + calib.txt parsing, cam->velo conversion,
`run.py --dataset kitti` end-to-end — exercised by nothing. This test
writes a miniature KITTI odometry layout (synthetic-world scans as
float32 xyzr .bin files, cam-frame poses through a nontrivial Tr calib)
and drives the full CLI over it.
"""
import json
import os

import numpy as np
import pytest

from scl_slam.io import kitti as kio


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_root")
    seq_dir = root / "sequences" / "99" / "velodyne"
    seq_dir.mkdir(parents=True)
    (root / "poses").mkdir()

    world = kio.SyntheticWorld(seed=5, extent=90.0, pts_per_cluster=500,
                               max_range=45.0)
    gt = kio.loop_trajectory(n_frames=24, radius=11.0, laps=2.0)

    # nontrivial velo->cam0 transform (KITTI's axis permutation:
    # cam x=-velo y, y=-velo z, z=velo x) — exercises the Tr conversion
    Tr = np.eye(4)
    Tr[:3, :3] = np.array([[0.0, -1.0, 0.0],
                           [0.0, 0.0, -1.0],
                           [1.0, 0.0, 0.0]])
    Tr[:3, 3] = [0.05, -0.1, 0.2]

    lines = []
    for k in range(len(gt)):
        scan = world.scan_at(gt[k], max_points=16384, seed=k)
        xyzr = np.concatenate(
            [scan.astype(np.float32),
             np.zeros((len(scan), 1), np.float32)], axis=1)
        xyzr.tofile(seq_dir / f"{k:06d}.bin")
        cam = Tr @ gt[k] @ np.linalg.inv(Tr)   # cam0 pose of frame k
        lines.append(" ".join(f"{v:.9e}" for v in cam[:3, :4].ravel()))
    (root / "poses" / "99.txt").write_text("\n".join(lines) + "\n")
    (root / "sequences" / "99" / "calib.txt").write_text(
        "Tr: " + " ".join(f"{v:.9e}" for v in Tr[:3, :4].ravel()) + "\n")
    return str(root), gt


def test_sequence_reader_roundtrip(mini_kitti):
    root, gt = mini_kitti
    seq = kio.KittiSequence(root, "99")
    assert len(seq) == len(gt)
    scan = seq.scan(0)
    assert scan.shape[1] == 3 and len(scan) > 1000
    # cam->velo conversion must return the ORIGINAL velodyne-frame poses
    for k in (0, 7, len(gt) - 1):
        np.testing.assert_allclose(seq.gt_pose_velo(k), gt[k], atol=1e-6)


def test_cli_end_to_end(mini_kitti, tmp_path, capsys):
    from scl_slam import run as cli

    root, gt = mini_kitti
    out = str(tmp_path / "kitti_run")
    rc = cli.main([
        "--dataset", "kitti", "--root", root, "--sequence", "99",
        "--frames", str(len(gt)), "--platform", "cpu", "--output", out,
    ])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["keyframes"] > 0
    # odometry is the (converted) gt chain, so ATE must be ~0 and the
    # export artifacts must exist
    assert report["ate_rmse_m"] < 0.05, report
    assert os.path.exists(os.path.join(out, "a_tum.txt"))
    assert os.path.exists(report["figure"])


def test_cli_native_loader(mini_kitti, tmp_path, capsys):
    """--loader native: the threaded C++ prefetcher drives the same run."""
    from scl_slam.io import native_loader
    from scl_slam import run as cli

    if native_loader.load_library() is None:
        pytest.skip("native library not built")
    root, gt = mini_kitti
    out = str(tmp_path / "kitti_native")
    rc = cli.main([
        "--dataset", "kitti", "--root", root, "--sequence", "99",
        "--frames", str(len(gt)), "--platform", "cpu", "--output", out,
        "--loader", "native", "--no-figure",
    ])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["keyframes"] > 0
    assert report["ate_rmse_m"] < 0.05, report

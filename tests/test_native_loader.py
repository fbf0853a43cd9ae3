import numpy as np
import pytest

from scl_slam.io import native_loader


@pytest.fixture(scope="module")
def bin_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scans")
    rng = np.random.RandomState(0)
    paths, truths = [], []
    for k in range(5):
        n = 100 + 50 * k
        pts = rng.uniform(-50, 50, (n, 4)).astype(np.float32)
        p = d / f"{k:06d}.bin"
        pts.tofile(p)
        paths.append(str(p))
        truths.append(pts[:, :3])
    return paths, truths


class TestNativeLoader:
    def test_builds(self):
        assert native_loader.load_library() is not None

    def test_reads_in_order(self, bin_files):
        paths, truths = bin_files
        loader = native_loader.NativeScanLoader(paths, capacity=512, workers=3)
        out = list(loader)
        assert len(out) == 5
        for (xyz, n), truth in zip(out, truths):
            assert n == len(truth)
            np.testing.assert_array_equal(xyz[:n], truth)
            assert np.all(xyz[n:] == 1e6)
        loader.close()

    def test_truncates_at_capacity(self, bin_files):
        paths, truths = bin_files
        loader = native_loader.NativeScanLoader(paths, capacity=120)
        (xyz, n) = next(iter(loader))
        assert n == 100  # first file fits
        loader.close()
        loader = native_loader.NativeScanLoader([paths[4]], capacity=120)
        (xyz, n) = next(iter(loader))
        assert n == 120  # truncated from 300
        np.testing.assert_array_equal(xyz, truths[4][:120])
        loader.close()


class TestNativeScDescriptors:
    def test_images_match_device(self):
        """C++ input-pipeline binning must reproduce the device Scan
        Context image (same f32 binning semantics; the polynomial atan2
        may only disagree within ~2e-7 rad of a sector boundary)."""
        import jax
        import jax.numpy as jnp
        from scl_slam.descriptors import scan_context as sc
        from scl_slam.ops.pointcloud import Cloud

        cfg = sc.ScanContextConfig()
        rng = np.random.RandomState(3)
        B, N = 4, 8192
        theta = rng.uniform(-np.pi, np.pi, (B, N))
        r = rng.uniform(1, 90, (B, N))  # includes out-of-range radii
        z = rng.uniform(-2, 6, (B, N))
        xyz = np.stack(
            [r * np.cos(theta), r * np.sin(theta), z], -1
        ).astype(np.float32)
        mask = rng.rand(B, N) > 0.1

        imgs_c = native_loader.sc_images_batch(
            xyz, mask, cfg.num_rings, cfg.num_sectors,
            cfg.max_radius, cfg.lidar_height, n_threads=2,
        )
        assert imgs_c is not None
        make = jax.jit(jax.vmap(lambda x, m: sc.make(Cloud(x, m), cfg).image))
        imgs_d = np.asarray(make(jnp.asarray(xyz), jnp.asarray(mask)))
        # boundary drift can move one point to an adjacent sector; bound
        # the number of affected bins, not just the magnitude
        mismatch = np.abs(imgs_c - imgs_d) > 1e-5
        assert mismatch.sum() <= 2, (
            f"{mismatch.sum()} bins disagree (max "
            f"{np.abs(imgs_c - imgs_d).max()})"
        )

    def test_all_masked_and_out_of_range(self):
        from scl_slam.descriptors import scan_context as sc

        cfg = sc.ScanContextConfig()
        xyz = np.full((1, 64, 3), 500.0, np.float32)  # all beyond max_radius
        img = native_loader.sc_images_batch(
            xyz, np.ones((1, 64), bool), cfg.num_rings, cfg.num_sectors,
            cfg.max_radius, cfg.lidar_height,
        )
        assert (img == 0).all()
        img2 = native_loader.sc_images_batch(
            np.zeros((1, 64, 3), np.float32), np.zeros((1, 64), bool),
            cfg.num_rings, cfg.num_sectors, cfg.max_radius, cfg.lidar_height,
        )
        assert (img2 == 0).all()

    def test_replay_host_descriptors_equals_device(self):
        """Mapper.replay(host_descriptors=True) must produce the same loop
        decisions and state as the all-device replay path."""
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
        m1.replay(odom, scans, stamps=stamps, batch=4, chunk_batches=4,
                  host_descriptors=False)
        m2 = Mapper(cfg)
        out = m2.replay(odom, scans, stamps=stamps, batch=4, chunk_batches=4,
                        host_descriptors=True)
        assert all(out["accepted"])

        n1, n2 = int(m1.state.loop_queue.count), int(m2.state.loop_queue.count)
        assert n1 > 0, "revisit trajectory produced no loops"
        assert n2 == n1
        np.testing.assert_array_equal(
            np.asarray(m2.state.loop_queue.i[:n1]),
            np.asarray(m1.state.loop_queue.i[:n1]),
        )
        np.testing.assert_allclose(
            np.asarray(m2.state.loop_queue.z_t[:n1]),
            np.asarray(m1.state.loop_queue.z_t[:n1]),
            atol=5e-3,
        )
        np.testing.assert_allclose(
            np.asarray(m2.state.opt_t), np.asarray(m1.state.opt_t), atol=5e-3
        )

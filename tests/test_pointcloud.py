import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3, so3
from scl_slam.ops import pointcloud as pc


def make_cloud(key, n_valid, capacity, scale=10.0):
    pts = jax.random.uniform(key, (n_valid, 3), minval=-scale, maxval=scale)
    return pc.from_points(np.asarray(pts), capacity)


class TestCloud:
    def test_from_points_pads(self):
        cloud = make_cloud(jax.random.PRNGKey(0), 100, 128)
        assert cloud.capacity == 128
        assert int(cloud.count()) == 100
        assert np.all(np.asarray(cloud.xyz[100:]) == pc.PAD_VALUE)

    def test_transform_matches_se3(self):
        key = jax.random.PRNGKey(1)
        cloud = make_cloud(key, 100, 128)
        R = so3.exp(jnp.array([0.1, 0.2, 0.3]))
        t = jnp.array([1.0, -2.0, 0.5])
        out = pc.transform(cloud, R, t)
        expected = se3.transform_points(se3.Pose(R, t), cloud.xyz[:100])
        np.testing.assert_allclose(
            np.asarray(out.xyz[:100]), np.asarray(expected), atol=1e-5
        )
        # padded points stay at sentinel
        assert np.all(np.asarray(out.xyz[100:]) == pc.PAD_VALUE)


class TestVoxelDownsample:
    def test_dedup_same_voxel(self):
        # many points in the same voxel -> one representative
        pts = np.random.RandomState(0).uniform(0, 0.4, (50, 3)).astype(np.float32)
        cloud = pc.from_points(pts, 64)
        out = pc.voxel_downsample(cloud, leaf=0.5)
        assert int(out.count()) == 1

    def test_grid_preserved(self):
        # points on a coarse grid, leaf smaller than spacing -> all kept
        g = np.stack(np.meshgrid(*[np.arange(4) * 2.0] * 3), axis=-1).reshape(-1, 3)
        cloud = pc.from_points(g.astype(np.float32), 128)
        out = pc.voxel_downsample(cloud, leaf=0.5)
        assert int(out.count()) == 64

    def test_count_reduction_realistic(self):
        key = jax.random.PRNGKey(2)
        cloud = make_cloud(key, 2000, 2048, scale=20.0)
        out = pc.voxel_downsample(cloud, leaf=4.0)
        n = int(out.count())
        # 10x10x10 voxel space, 2000 pts: heavy reduction but non-trivial
        assert 100 < n < 1300

    def test_representatives_are_input_points(self):
        key = jax.random.PRNGKey(3)
        cloud = make_cloud(key, 500, 512)
        out = pc.voxel_downsample(cloud, leaf=2.0)
        kept = np.asarray(out.xyz)[np.asarray(out.mask)]
        orig = np.asarray(cloud.xyz)[: int(cloud.count())]
        for p in kept[:20]:
            assert np.min(np.linalg.norm(orig - p, axis=1)) < 1e-6


class TestPolarBins:
    def test_known_points(self):
        xyz = jnp.array(
            [
                [1.0, 0.0, 0.0],    # theta=0 -> sector 30 of 60 (frac 0.5)
                [-1.0, 0.0, 0.0],   # theta=pi -> sector 0 or 59 (wraps)
                [0.0, 1.0, 0.0],    # theta=pi/2 -> sector 45
                [79.0, 0.0, 0.0],   # outer ring
                [100.0, 0.0, 0.0],  # out of range -> invalid
            ]
        )
        mask = jnp.ones(5, bool)
        ring, sector, valid = pc.polar_bins(xyz, mask, 20, 60, 80.0)
        assert sector[0] == 30
        assert sector[2] == 45
        assert ring[0] == 0
        assert ring[3] == 19
        assert bool(valid[3]) and not bool(valid[4])

    def test_scatter_max(self):
        xyz = jnp.array([[1.0, 0.0, 0.5], [1.05, 0.0, 2.0], [0.0, 40.0, 1.0]])
        mask = jnp.ones(3, bool)
        ring, sector, valid = pc.polar_bins(xyz, mask, 20, 60, 80.0)
        img = pc.scatter_max_image(xyz[:, 2], ring, sector, valid, 20, 60)
        # both first points fall in same bin -> max z = 2.0
        assert img[int(ring[0]), int(sector[0])] == 2.0
        assert img[int(ring[2]), int(sector[2])] == 1.0
        assert float(jnp.sum(img > 0)) == 2  # only two occupied bins


class TestNormals:
    def test_plane_normals(self):
        # points on z=0 plane -> normals ~ +-z
        key = jax.random.PRNGKey(4)
        xy = jax.random.uniform(key, (512, 2), minval=-5, maxval=5)
        pts = jnp.concatenate([xy, jnp.zeros((512, 1))], axis=-1)
        cloud = pc.Cloud(pts, jnp.ones(512, bool))
        normals = pc.estimate_normals(cloud, k=8)
        nz = np.abs(np.asarray(normals)[:, 2])
        assert np.mean(nz > 0.99) > 0.95


class TestVoxelDownsampleHash:
    """Sort-free hash-scatter variant (the ingest fast path)."""

    def test_one_rep_per_voxel(self):
        rng = np.random.RandomState(1)
        pts = rng.uniform(-30, 30, (4096, 3)).astype(np.float32)
        cloud = pc.from_points(pts, 4096)
        out = pc.voxel_downsample_hash(cloud, leaf=0.5, out_capacity=4096)
        kept = np.asarray(out.xyz)[np.asarray(out.mask)]
        vox = np.floor(kept / 0.5).astype(np.int64)
        keys = vox[:, 0] * (1 << 42) + vox[:, 1] * (1 << 21) + vox[:, 2]
        assert len(np.unique(keys)) == len(keys), "two reps share a voxel"

    def test_representatives_are_input_points(self):
        rng = np.random.RandomState(2)
        pts = rng.uniform(-30, 30, (2048, 3)).astype(np.float32)
        cloud = pc.from_points(pts, 2048)
        out = pc.voxel_downsample_hash(cloud, leaf=0.5, out_capacity=2048)
        kept = np.asarray(out.xyz)[np.asarray(out.mask)]
        assert len(kept) > 0
        for p in kept[:32]:
            assert np.min(np.linalg.norm(pts - p, axis=1)) < 1e-6

    def test_close_to_exact_count(self):
        rng = np.random.RandomState(3)
        # LiDAR-like ring geometry, ~20k points
        theta = rng.uniform(-np.pi, np.pi, 20000)
        r = rng.uniform(2, 60, 20000)
        z = np.sin(theta * 3) + rng.normal(0, 0.3, 20000)
        pts = np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(
            np.float32
        )
        cloud = pc.from_points(pts, 32768)
        exact = pc.voxel_downsample(cloud, leaf=0.3, out_capacity=16384)
        # collision loss ~ n_voxels/(2*hash_slots): size the table ~10x the
        # voxel count for <5% loss (at the default 2^15 the loss is ~12% —
        # immaterial on the ingest path, where out_capacity truncates far
        # below the occupied-slot count anyway)
        fast = pc.voxel_downsample_hash(
            cloud, leaf=0.3, out_capacity=16384, hash_slots=1 << 18
        )
        ne, nf = int(exact.count()), int(fast.count())
        assert nf <= ne
        assert nf > 0.95 * ne, (ne, nf)

    def test_compaction_prefix_dense(self):
        rng = np.random.RandomState(4)
        pts = rng.uniform(-10, 10, (1024, 3)).astype(np.float32)
        cloud = pc.from_points(pts, 1024)
        out = pc.voxel_downsample_hash(cloud, leaf=1.0, out_capacity=512)
        m = np.asarray(out.mask)
        n = m.sum()
        assert m[:n].all() and not m[n:].any(), "mask must be a dense prefix"
        # padded lanes carry the sentinel
        assert (np.asarray(out.xyz)[n:] == pc.PAD_VALUE).all()

    def test_stride_permute_full_cloud_distinct(self):
        # power-of-two out_capacity on a full cloud: scramble is a bijection,
        # so every output row is a distinct input point
        rng = np.random.RandomState(6)
        pts = rng.uniform(-30, 30, (4096, 3)).astype(np.float32)
        cloud = pc.from_points(pts, 4096)
        out = pc.stride_permute_downsample(cloud, 1024)
        assert int(out.count()) == 1024
        kept = np.asarray(out.xyz)
        keys = {p.tobytes() for p in kept}
        all_keys = {p.tobytes() for p in pts}
        assert len(keys) == 1024
        assert keys <= all_keys

    def test_stride_permute_underfilled_stays_dense(self):
        # only 1000 of 4096 slots valid: output must still be fully dense
        # and drawn exclusively from the valid prefix
        rng = np.random.RandomState(7)
        pts = rng.uniform(-30, 30, (1000, 3)).astype(np.float32)
        cloud = pc.from_points(pts, 4096)
        out = pc.stride_permute_downsample(cloud, 512)
        m = np.asarray(out.mask)
        assert m.all(), "output mask must be fully dense"
        kept = np.asarray(out.xyz)
        all_keys = {p.tobytes() for p in pts}
        for p in kept:
            assert p.tobytes() in all_keys, "gathered a padded row"

    def test_stride_permute_empty_cloud(self):
        cloud = pc.Cloud(
            jnp.full((256, 3), pc.PAD_VALUE), jnp.zeros(256, bool)
        )
        out = pc.stride_permute_downsample(cloud, 64)
        assert int(out.count()) == 0
        assert (np.asarray(out.xyz) == pc.PAD_VALUE).all()

    def test_stride_permute_prefix_azimuth_coverage(self):
        # scans arrive azimuth-ordered; any short PREFIX of the output must
        # already cover the sweep (the property submap gathers rely on)
        theta = np.linspace(-np.pi, np.pi, 8192, endpoint=False)
        pts = np.stack(
            [10 * np.cos(theta), 10 * np.sin(theta), np.zeros_like(theta)], -1
        ).astype(np.float32)
        cloud = pc.from_points(pts, 8192)
        out = pc.stride_permute_downsample(cloud, 2048)
        prefix = np.asarray(out.xyz)[:128]
        ang = np.arctan2(prefix[:, 1], prefix[:, 0])
        hist, _ = np.histogram(ang, bins=16, range=(-np.pi, np.pi))
        assert (hist > 0).all(), f"azimuth bins uncovered: {hist}"

    def test_large_cloud_falls_back_to_exact(self):
        rng = np.random.RandomState(5)
        pts = rng.uniform(-30, 30, (1000, 3)).astype(np.float32)
        cloud = pc.from_points(pts, 1 << 17)  # capacity > 65536
        out = pc.voxel_downsample_hash(cloud, leaf=0.5, out_capacity=1024)
        ref = pc.voxel_downsample(cloud, leaf=0.5, out_capacity=1024)
        np.testing.assert_array_equal(np.asarray(out.mask), np.asarray(ref.mask))

import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.descriptors import lidar_iris as li
from scl_slam.ops import pointcloud as pc

from test_scan_context import ring_cloud, rotate_cloud

CFG = li.LidarIrisConfig(exclude_recent=5)


class TestMake:
    def test_shapes_and_range(self):
        iris = li.make(ring_cloud(jax.random.PRNGKey(0)), CFG)
        assert iris.image.shape == (80, 360)
        assert iris.row_key.shape == (80,)
        img = np.asarray(iris.image)
        assert img.min() >= 0 and img.max() <= 255

    def test_rotation_shifts_columns(self):
        cloud = ring_cloud(jax.random.PRNGKey(1))
        i0 = li.make(cloud, CFG)
        # rotate by exactly 10 azimuth bins = 10 degrees
        yaw = 10 * 2 * np.pi / 360
        i1 = li.make(rotate_cloud(cloud, yaw), CFG)
        rolled = np.roll(np.asarray(i0.image), 10, axis=1)
        # most cells should agree exactly (binning jitter at boundaries)
        agree = np.mean(rolled == np.asarray(i1.image))
        assert agree > 0.85

    def test_row_key_rotation_invariant(self):
        cloud = ring_cloud(jax.random.PRNGKey(2))
        k0 = li.make(cloud, CFG).row_key
        k1 = li.make(rotate_cloud(cloud, 1.3), CFG).row_key
        np.testing.assert_allclose(np.asarray(k0), np.asarray(k1), rtol=0.15, atol=2.0)


class TestMatch:
    def test_self_distance_zero(self):
        iris = li.make(ring_cloud(jax.random.PRNGKey(3)), CFG)
        d, yaw = li.match_pair(iris.image, iris.image, CFG)
        assert float(d) < 0.01
        assert float(yaw) == 0.0

    def test_rotation_recovered(self):
        cloud = ring_cloud(jax.random.PRNGKey(4))
        i0 = li.make(cloud, CFG)
        yaw_true = 25 * 2 * np.pi / 360
        i1 = li.make(rotate_cloud(cloud, yaw_true), CFG)
        d, yaw = li.match_pair(i1.image, i0.image, CFG)
        assert float(d) < CFG.distance_threshold
        # the recovered yaw aligns i0 onto i1 (sign convention: column shift)
        assert abs(abs(float(yaw)) - yaw_true) < 0.05

    def test_different_scenes_far(self):
        i0 = li.make(ring_cloud(jax.random.PRNGKey(5)), CFG)
        key = jax.random.PRNGKey(6)
        xyz = jax.random.uniform(key, (2048, 3), minval=-40, maxval=40)
        i1 = li.make(pc.Cloud(xyz, jnp.ones(2048, bool)), CFG)
        d, _ = li.match_pair(i0.image, i1.image, CFG)
        assert float(d) > CFG.distance_threshold


class TestQuery:
    def test_intra_loop_found(self):
        key = jax.random.PRNGKey(7)
        db = li.make_db(64, CFG)
        clouds = [ring_cloud(jax.random.fold_in(key, i)) for i in range(20)]
        for i, c in enumerate(clouds):
            db = li.insert(db, li.make(c, CFG), robot=0, index=i)
        q = li.make(rotate_cloud(clouds[4], 0.4), CFG)
        m = li.query(db, q, jnp.array(0), jnp.array(20), CFG, mode="intra")
        assert bool(m.found)
        assert int(m.index) == 4

    def test_wire_roundtrip(self):
        iris = li.make(ring_cloud(jax.random.PRNGKey(8)), CFG)
        i2 = li.from_wire(li.to_wire(iris), CFG)
        np.testing.assert_array_equal(np.asarray(iris.image), np.asarray(i2.image))


class TestDFT:
    """The quadrature encoding runs on jnp.fft (cuFFT on the GPU, the CPU's
    FFT here); it must reproduce a float64 numpy.fft encoding wherever a
    bit is clear of f32 rounding."""

    def test_encoding_matches_numpy_fft(self):
        cloud0 = ring_cloud(jax.random.PRNGKey(7))
        img = np.asarray(li.make(cloud0, CFG).image)
        T, M = li.encode_features(jnp.asarray(img), CFG)
        bank = np.asarray(li.log_gabor_bank(CFG))
        resp = np.fft.ifft(
            np.fft.fft(img.astype(np.float64), axis=-1)[None]
            * bank[:, None, :],
            axis=-1,
        )
        T_np = np.stack([resp.real > 0, resp.imag > 0], axis=-1)
        M_np = np.abs(resp) < (li._M_THRESH_REF / CFG.cols)
        clear = np.stack([np.abs(resp.real), np.abs(resp.imag)], -1) > 1e-4
        assert clear.mean() > 0.2
        assert (np.asarray(T) == T_np)[clear].mean() > 0.999   # quadrature
        assert (np.asarray(M) == M_np).mean() > 0.999          # noise masks

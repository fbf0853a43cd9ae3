import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.descriptors import geometric as geo
from scl_slam.descriptors import m2dp
from scl_slam.ops import pointcloud as pc

from test_scan_context import ring_cloud, rotate_cloud

M2DP_CFG = m2dp.M2DPConfig(exclude_recent=3)
GRSD_CFG = geo.GRSDConfig(exclude_recent=3)
FPFH_CFG = geo.FPFHConfig(exclude_recent=3)


def small_cloud(key, n=512):
    c = ring_cloud(key, n=n)
    return c


class TestM2DP:
    def test_shape_and_norm(self):
        d = m2dp.make(small_cloud(jax.random.PRNGKey(0)), M2DP_CFG)
        assert d.descriptor.shape == (192,)
        assert abs(float(jnp.linalg.norm(d.descriptor)) - 1.0) < 1e-5

    def test_rotation_invariance(self):
        c = small_cloud(jax.random.PRNGKey(1))
        d0 = m2dp.make(c, M2DP_CFG)
        d1 = m2dp.make(rotate_cloud(c, 1.1), M2DP_CFG)
        dist = float(jnp.linalg.norm(d0.descriptor - d1.descriptor))
        assert dist < M2DP_CFG.distance_threshold

    def test_discrimination(self):
        d0 = m2dp.make(small_cloud(jax.random.PRNGKey(2)), M2DP_CFG)
        key = jax.random.PRNGKey(3)
        xyz = jax.random.uniform(key, (512, 3), minval=-40, maxval=40)
        d1 = m2dp.make(pc.Cloud(xyz, jnp.ones(512, bool)), M2DP_CFG)
        same = float(jnp.linalg.norm(d0.descriptor - d0.descriptor))
        diff = float(jnp.linalg.norm(d0.descriptor - d1.descriptor))
        assert diff > same

    def test_query(self):
        db = m2dp.make_db(32, M2DP_CFG)
        clouds = [small_cloud(jax.random.fold_in(jax.random.PRNGKey(4), i)) for i in range(8)]
        for i, c in enumerate(clouds):
            db = m2dp.insert(db, m2dp.make(c, M2DP_CFG), 0, i)
        q = m2dp.make(rotate_cloud(clouds[2], 0.7), M2DP_CFG)
        m = m2dp.query(db, q, jnp.array(0), jnp.array(8), M2DP_CFG, mode="intra")
        assert bool(m.found) and int(m.index) == 2


class TestGRSD:
    def test_shape(self):
        d = geo.grsd_make(small_cloud(jax.random.PRNGKey(5)), GRSD_CFG)
        assert d.descriptor.shape == (21,)
        assert np.all(np.isfinite(np.asarray(d.descriptor)))

    def test_similar_scenes_close(self):
        c = small_cloud(jax.random.PRNGKey(6))
        d0 = geo.grsd_make(c, GRSD_CFG)
        d1 = geo.grsd_make(rotate_cloud(c, 0.5), GRSD_CFG)
        dist = float(jnp.linalg.norm(d0.descriptor - d1.descriptor))
        assert dist < GRSD_CFG.distance_threshold

    def test_query_api(self):
        db = geo.make_db(32, 21)
        for i in range(6):
            d = geo.grsd_make(small_cloud(jax.random.fold_in(jax.random.PRNGKey(7), i)), GRSD_CFG)
            db = geo.insert(db, d.descriptor, 0 if i < 3 else 1, i % 3)
        q = geo.grsd_make(small_cloud(jax.random.fold_in(jax.random.PRNGKey(7), 4)), GRSD_CFG)
        m = geo.vector_query(
            db, q.descriptor, jnp.array(0), jnp.array(3),
            num_candidates=3, exclude_recent=0,
            threshold=GRSD_CFG.distance_threshold, mode="inter",
        )
        # exact same cloud exists in robot 1's slots -> must be found
        assert bool(m.found) and int(m.robot) == 1


class TestFPFH:
    def test_shape_and_norm(self):
        d = geo.fpfh_make(small_cloud(jax.random.PRNGKey(8)), FPFH_CFG)
        assert d.descriptor.shape == (33,)
        # PCL convention: each 11-bin block sums to ~100
        s = float(jnp.sum(d.descriptor))
        assert 250 < s < 350

    def test_repeatability(self):
        c = small_cloud(jax.random.PRNGKey(9))
        d0 = geo.fpfh_make(c, FPFH_CFG)
        d1 = geo.fpfh_make(c, FPFH_CFG)
        np.testing.assert_allclose(
            np.asarray(d0.descriptor), np.asarray(d1.descriptor), atol=1e-4
        )

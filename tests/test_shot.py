import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.descriptors import shot

from test_scan_context import ring_cloud, rotate_cloud

CFG = shot.SHOTConfig()


class TestSHOT:
    def test_shape_and_norm(self):
        d = shot.shot_make(ring_cloud(jax.random.PRNGKey(0), n=512), CFG)
        assert d.descriptor.shape == (CFG.dim,)
        assert abs(float(jnp.sum(d.descriptor)) - 100.0) < 1.0

    def test_rotation_invariance(self):
        c = ring_cloud(jax.random.PRNGKey(1), n=512)
        d0 = shot.shot_make(c, CFG)
        d1 = shot.shot_make(rotate_cloud(c, 0.9), CFG)
        assert float(jnp.linalg.norm(d0.descriptor - d1.descriptor)) < 5.0

    def test_discrimination(self):
        d0 = shot.shot_make(ring_cloud(jax.random.PRNGKey(2), n=512), CFG)
        d1 = shot.shot_make(ring_cloud(jax.random.PRNGKey(9), n=512), CFG)
        same = shot.shot_make(ring_cloud(jax.random.PRNGKey(2), n=512), CFG)
        d_same = float(jnp.linalg.norm(d0.descriptor - same.descriptor))
        d_diff = float(jnp.linalg.norm(d0.descriptor - d1.descriptor))
        assert d_same < 1e-4
        assert d_diff > 1.0

    def test_query_api(self):
        db = shot.make_db(16, CFG.dim)
        for i in range(4):
            d = shot.shot_make(ring_cloud(jax.random.PRNGKey(10 + i), n=512), CFG)
            db = shot.insert(db, d.descriptor, 1, i)
        q = shot.shot_make(ring_cloud(jax.random.PRNGKey(12), n=512), CFG)
        m = shot.vector_query(
            db, q.descriptor, jnp.array(0), jnp.array(0),
            num_candidates=3, exclude_recent=0,
            threshold=CFG.distance_threshold, mode="inter",
        )
        assert bool(m.found) and int(m.index) == 2

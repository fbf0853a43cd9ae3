import jax
import jax.numpy as jnp
import numpy as np

from scl_slam.descriptors import base, scan_context as sc
from scl_slam.ops import pointcloud as pc

CFG = sc.ScanContextConfig(exclude_recent=5)  # small exclusion for tests


def ring_cloud(key, n=2048, scale=60.0, seed_structure=True):
    """Synthetic LiDAR-ish scan: structured points at varying radii/heights."""
    k1, k2, k3 = jax.random.split(key, 3)
    theta = jax.random.uniform(k1, (n,), minval=-np.pi, maxval=np.pi)
    r = jax.random.uniform(k2, (n,), minval=2.0, maxval=scale)
    # height correlated with angle so the descriptor has azimuthal structure
    z = jnp.sin(theta * 3.0) * 2.0 + jax.random.normal(k3, (n,)) * 0.3
    xyz = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), z], axis=-1)
    return pc.Cloud(xyz, jnp.ones(n, bool))


def rotate_cloud(cloud, yaw):
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    R = jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return pc.Cloud(cloud.xyz @ R.T, cloud.mask)


class TestMake:
    def test_shapes(self):
        d = sc.make(ring_cloud(jax.random.PRNGKey(0)), CFG)
        assert d.image.shape == (20, 60)
        assert d.ring_key.shape == (20,)
        assert d.sector_key.shape == (60,)

    def test_ring_key_rotation_invariant(self):
        cloud = ring_cloud(jax.random.PRNGKey(1))
        d0 = sc.make(cloud, CFG)
        d1 = sc.make(rotate_cloud(cloud, 1.0), CFG)
        # ring key (row means) is invariant to yaw rotation up to binning noise
        np.testing.assert_allclose(
            np.asarray(d0.ring_key), np.asarray(d1.ring_key), rtol=0.1, atol=0.1
        )

    def test_wire_roundtrip(self):
        d = sc.make(ring_cloud(jax.random.PRNGKey(2)), CFG)
        d2 = sc.from_wire(sc.to_wire(d), CFG)
        np.testing.assert_array_equal(np.asarray(d.image), np.asarray(d2.image))


class TestDistance:
    def test_self_distance_zero(self):
        d = sc.make(ring_cloud(jax.random.PRNGKey(3)), CFG)
        dist, shift = sc.shifted_cosine_distance(d.image, d.image[None])
        assert float(dist[0]) < 1e-5
        assert int(shift[0]) == 0

    def test_rotation_recovered(self):
        cloud = ring_cloud(jax.random.PRNGKey(4))
        d0 = sc.make(cloud, CFG)
        # rotate by exactly 5 sectors = 30 degrees
        yaw_true = 5 * 2 * np.pi / 60
        d1 = sc.make(rotate_cloud(cloud, yaw_true), CFG)
        dist, shift = sc.shifted_cosine_distance(d1.image, d0.image[None])
        assert float(dist[0]) < 0.05
        yaw_est = float(sc.shift_to_yaw(shift[0], 60))
        assert abs(abs(yaw_est) - yaw_true) < 0.11  # within one sector

    def test_different_scenes_far(self):
        d0 = sc.make(ring_cloud(jax.random.PRNGKey(5)), CFG)
        key = jax.random.PRNGKey(6)
        # genuinely different scene: different radial structure
        k1, k2 = jax.random.split(key)
        xyz = jax.random.uniform(k1, (2048, 3), minval=-40, maxval=40)
        xyz = xyz.at[:, 2].set(jax.random.uniform(k2, (2048,), minval=0, maxval=8))
        d1 = sc.make(pc.Cloud(xyz, jnp.ones(2048, bool)), CFG)
        dist, _ = sc.shifted_cosine_distance(d0.image, d1.image[None])
        assert float(dist[0]) > CFG.distance_threshold


class TestQueryDB:
    def _build_db(self, n=30, key=None):
        key = key or jax.random.PRNGKey(7)
        db = sc.make_db(128, CFG)
        clouds = []
        for i in range(n):
            cloud = ring_cloud(jax.random.fold_in(key, i))
            clouds.append(cloud)
            d = sc.make(cloud, CFG)
            db = sc.insert(db, d, robot=0, index=i)
        return db, clouds

    def test_intra_loop_found(self):
        db, clouds = self._build_db()
        # revisit of frame 3 (rotated), queried as frame 30
        d = sc.make(rotate_cloud(clouds[3], 0.3), CFG)
        m = sc.query(db, d, jnp.array(0), jnp.array(30), CFG, mode="intra")
        assert bool(m.found)
        assert int(m.index) == 3
        assert int(m.robot) == 0

    def test_recent_excluded(self):
        db, clouds = self._build_db()
        # exact copy of the most recent frame must NOT match (exclusion window)
        d = sc.make(clouds[29], CFG)
        m = sc.query(db, d, jnp.array(0), jnp.array(30), CFG, mode="intra")
        assert int(m.index) != 29

    def test_inter_excludes_own_robot(self):
        db, clouds = self._build_db()
        # add peer robot frames, one matching our query
        peer_cloud = ring_cloud(jax.random.PRNGKey(99))
        d_peer = sc.make(peer_cloud, CFG)
        db = sc.insert(db, d_peer, robot=1, index=0)
        q = sc.make(rotate_cloud(peer_cloud, 0.2), CFG)
        m = sc.query(db, q, jnp.array(0), jnp.array(31), CFG, mode="inter")
        assert bool(m.found)
        assert int(m.robot) == 1

    def test_no_match_in_empty_db(self):
        db = sc.make_db(128, CFG)
        d = sc.make(ring_cloud(jax.random.PRNGKey(8)), CFG)
        m = sc.query(db, d, jnp.array(0), jnp.array(0), CFG, mode="intra")
        assert not bool(m.found)

    def test_query_batch_matches_single(self):
        db, clouds = self._build_db()
        imgs = []
        keys = []
        for c in [clouds[3], clouds[7], clouds[11]]:
            d = sc.make(rotate_cloud(c, 0.25), CFG)
            imgs.append(d.image)
            keys.append(d.ring_key)
        B = len(imgs)
        out = sc.query_batch(
            db, jnp.stack(imgs), jnp.stack(keys),
            jnp.zeros(B, jnp.int32), jnp.full(B, 30, jnp.int32), CFG, mode="intra",
        )
        found_any = 0
        for b in range(B):
            single = sc.query(
                db, sc.ScanContext(imgs[b], keys[b], jnp.mean(imgs[b], axis=0)),
                jnp.array(0), jnp.array(30), CFG, mode="intra",
            )
            # batch must agree exactly with the single-query path
            assert int(out.index[b]) == int(single.index)
            assert bool(out.found[b]) == bool(single.found)
            np.testing.assert_allclose(
                float(out.distance[b]), float(single.distance), rtol=1e-5
            )
            found_any += int(single.found)
        assert found_any >= 1  # at least one revisit must clear the gate

    def test_db_insert_capacity(self):
        db = sc.make_db(4, CFG)
        d = sc.make(ring_cloud(jax.random.PRNGKey(9)), CFG)
        for i in range(6):
            db = sc.insert(db, d, robot=0, index=i)
        assert int(db.count) == 4  # silently full, no overwrite
        assert int(db.index[3]) == 3

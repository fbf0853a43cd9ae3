"""Row-sharded descriptor DB through the STANDARD query path.

The explicit shard_map retrieval lives in parallel/sharded.py; this test
validates the complementary route — put the DB arrays in a NamedSharding
over the 8-device mesh and run the unmodified jitted ``scan_context.query``:
XLA partitions the distance/top-k computation and inserts the collectives.
Results must be identical to the single-device path, which is what lets a
Mapper scale its descriptor DB across chips without code changes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scl_slam.descriptors import base, scan_context as sc

CFG = sc.ScanContextConfig(exclude_recent=5, num_candidates=8)


@pytest.fixture()
def mesh(mesh8):
    return mesh8


def build_db(n=256):
    rng = np.random.RandomState(0)
    imgs = jnp.asarray(rng.uniform(0, 8, (n, 20, 60)), jnp.float32)
    db = sc.make_db(n, CFG)
    return db._replace(
        descriptors=imgs,
        keys=jnp.mean(imgs, axis=2),
        robot=jnp.zeros(n, jnp.int32),
        index=jnp.arange(n, dtype=jnp.int32),
        count=jnp.array(n, jnp.int32),
    )


def test_sharded_db_query_matches_unsharded(mesh):
    db = build_db()
    q_img = db.descriptors[37]
    q = sc.ScanContext(q_img, db.keys[37], jnp.mean(q_img, axis=0))

    ref = sc.query(db, q, jnp.array(0), jnp.array(200), CFG, mode="intra")

    row = NamedSharding(mesh, P("shard"))
    rep = NamedSharding(mesh, P())
    sharded = base.DescriptorDB(
        descriptors=jax.device_put(db.descriptors, row),
        keys=jax.device_put(db.keys, row),
        robot=jax.device_put(db.robot, row),
        index=jax.device_put(db.index, row),
        count=jax.device_put(db.count, rep),
    )
    out = sc.query(sharded, q, jnp.array(0), jnp.array(200), CFG, mode="intra")

    assert bool(out.found) == bool(ref.found)
    assert int(out.index) == int(ref.index) == 37  # exact self-match
    np.testing.assert_allclose(float(out.distance), float(ref.distance), atol=1e-6)


def test_sharded_db_insert_roundtrip(mesh):
    db = build_db(128)
    row = NamedSharding(mesh, P("shard"))
    sharded = db._replace(
        descriptors=jax.device_put(db.descriptors, row),
        keys=jax.device_put(db.keys, row),
        robot=jax.device_put(db.robot, row),
        index=jax.device_put(db.index, row),
    )
    d = sc.ScanContext(
        db.descriptors[3] + 1.0, db.keys[3] + 1.0, jnp.mean(db.descriptors[3], 0)
    )
    out = sc.insert(sharded, d, robot=1, index=0, pos=64)
    assert int(out.robot[64]) == 1
    np.testing.assert_allclose(
        np.asarray(out.keys[64]), np.asarray(db.keys[3] + 1.0), atol=1e-6
    )


class TestShardedMapper:
    """Mapper.shard_database: the full keyframe pipeline with the descriptor
    DB partitioned across the mesh must be bit-identical to single-device."""

    def _cfg(self):
        from scl_slam.config import (
            KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams,
            SlamConfig,
        )

        return SlamConfig(
            keyframe=KeyframeConfig(
                max_keyframes=32, points_per_keyframe=256,
                raw_points_capacity=512, distance_threshold=0.5,
                evict_keep_recent=4,
            ),
            loop=LoopConfig(near_keyframes=2, submap_capacity=512,
                            queue_capacity=8, icp_iterations=5),
            optimizer=OptimizerConfig(edge_capacity=128, gn_iters=2, cg_iters=8),
            scan_context=ScanContextParams(exclude_recent=2),
        )

    def test_pipeline_matches_unsharded(self, mesh):
        from scl_slam.geometry import se3
        from scl_slam.runtime import Mapper

        cfg = self._cfg()
        plain, sharded = Mapper(cfg), Mapper(cfg)
        sharded.shard_database(mesh)
        rng = np.random.RandomState(5)
        # 40 keyframes on a 32-slot block: exercises eviction under sharding
        for k in range(40):
            xyz = rng.uniform(-20, 20, (256, 3)).astype(np.float32)
            pose = se3.Pose(jnp.eye(3), jnp.array([2.0 * k, 0.0, 0.0]))
            for m in (plain, sharded):
                m.add_frame(pose, xyz, stamp=float(k))

        assert int(plain.state.counts[0]) == int(sharded.state.counts[0])
        n = int(plain.state.counts[0])
        np.testing.assert_array_equal(
            np.asarray(plain.state.desc_db.index[:n]),
            np.asarray(sharded.state.desc_db.index[:n]),
        )
        np.testing.assert_allclose(
            np.asarray(plain.state.desc_db.keys[:n]),
            np.asarray(sharded.state.desc_db.keys[:n]),
            atol=1e-6,
        )
        assert int(plain.state.loop_queue.count) == int(
            sharded.state.loop_queue.count
        )
        p1, s1 = plain.full_trajectory(0)
        p2, s2 = sharded.full_trajectory(0)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_allclose(p1, p2, atol=1e-5)

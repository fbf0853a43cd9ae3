"""Descriptor protocol and fixed-capacity descriptor database.

JAX re-design of the reference's ``scan_descriptor`` abstract interface
(reference ``include/descriptor.h:21-36``):

    makeAndSaveDescriptorAndKey(cloud, robot, index)
    saveDescriptorAndKey(wire_floats, robot, index)
    detectIntraLoopClosureID(cur_ptr)
    detectInterLoopClosureID(cur_ptr)

Here every family exposes three pure functions over a functional ``DescriptorDB``
state (no mutexes — the reference guards its DB with ``mtxSC``,
``include/distributedMapping.h:328``; functional updates make that moot):

- ``make(cloud) -> (descriptor, key)``: jitted per-keyframe encoder.
- ``insert(db, descriptor, key, robot, index) -> db``: functional append.
- ``query(db, descriptor, key, query_robot, mode) -> Match``: batched
  retrieval (top-k over the key matrix) + full-descriptor verification.

The database replaces nanoflann/libnabo KD-trees with masked distance
matrices + ``lax.top_k`` — at the DB sizes involved (≤ tens of thousands of
20–80-dim keys, SURVEY §2.2) a single fused matmul beats tree traversal on
an accelerator and needs no periodic rebuild (the reference
rebuilds its tree every 10 insertions, ``include/descriptor.h:1691-1703``).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class DescriptorDB(NamedTuple):
    """Fixed-capacity global descriptor store shared by all families.

    ``descriptors``: [cap, ...desc_shape] full descriptors.
    ``keys``: [cap, key_dim] retrieval keys (ring keys / row keys / raw).
    ``robot``: [cap] int32 owner robot id.
    ``index``: [cap] int32 per-robot keyframe index.
    ``count``: scalar int32 number of valid entries (global index order,
    matching the reference's ``local2Global`` bookkeeping,
    ``include/descriptor.h:1297-1301``).
    """

    descriptors: jax.Array
    keys: jax.Array
    robot: jax.Array
    index: jax.Array
    count: jax.Array

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def make_db(capacity: int, desc_shape: tuple, key_dim: int, dtype=jnp.float32) -> DescriptorDB:
    return DescriptorDB(
        descriptors=jnp.zeros((capacity, *desc_shape), dtype=dtype),
        keys=jnp.zeros((capacity, key_dim), dtype=dtype),
        robot=jnp.full((capacity,), -1, dtype=jnp.int32),
        index=jnp.full((capacity,), -1, dtype=jnp.int32),
        count=jnp.zeros((), dtype=jnp.int32),
    )


def db_insert(
    db: DescriptorDB,
    descriptor: jax.Array,
    key: jax.Array,
    robot: jax.Array | int,
    index: jax.Array | int,
    pos: jax.Array | int | None = None,
) -> DescriptorDB:
    """Functional insert.

    With ``pos`` (the global keyframe slot robot*K+index): deterministic
    slot-addressed storage — REQUIRED in multi-robot runs, where append order
    interleaves robots' streams and row position would no longer equal the
    keyframe slot the retrieval side reads. Without ``pos``: append at
    ``count`` (single-stream convenience; no-op when full).
    """
    if pos is None:
        pos = jnp.minimum(db.count, db.capacity - 1)
        ok = db.count < db.capacity
    else:
        pos = jnp.asarray(pos)
        ok = (pos >= 0) & (pos < db.capacity)
        pos = jnp.clip(pos, 0, db.capacity - 1)
    return DescriptorDB(
        descriptors=db.descriptors.at[pos].set(
            jnp.where(ok, descriptor, db.descriptors[pos])
        ),
        keys=db.keys.at[pos].set(jnp.where(ok, key, db.keys[pos])),
        robot=db.robot.at[pos].set(jnp.where(ok, robot, db.robot[pos])),
        index=db.index.at[pos].set(jnp.where(ok, index, db.index[pos])),
        count=db.count + ok.astype(jnp.int32),
    )


def db_insert_block(
    db: DescriptorDB,
    descriptors: jax.Array,
    keys: jax.Array,
    robot: jax.Array | int,
    indices: jax.Array,
    pos0: jax.Array,
) -> DescriptorDB:
    """Contiguous B-row insert at rows ``pos0 .. pos0+B-1``.

    The macro-batch ingest path: B frames of one robot always land in
    consecutive slots, so the B per-frame ``db_insert`` scatters collapse to
    ONE dynamic_update_slice per DB array. Caller guarantees
    ``0 <= pos0`` and ``pos0 + B <= capacity`` (runtime/mapper.Mapper
    enforces this before dispatching a batch).
    """
    B = indices.shape[0]
    rob = jnp.broadcast_to(jnp.asarray(robot, jnp.int32), (B,))
    start = (pos0,) + (0,) * (db.descriptors.ndim - 1)
    return DescriptorDB(
        descriptors=jax.lax.dynamic_update_slice(
            db.descriptors, descriptors.astype(db.descriptors.dtype), start
        ),
        keys=jax.lax.dynamic_update_slice(
            db.keys, keys.astype(db.keys.dtype), (pos0, 0)
        ),
        robot=jax.lax.dynamic_update_slice(db.robot, rob, (pos0,)),
        index=jax.lax.dynamic_update_slice(
            db.index, indices.astype(jnp.int32), (pos0,)
        ),
        count=db.count + B,
    )


def db_insert_rows(
    db: DescriptorDB,
    descriptors: jax.Array,
    keys: jax.Array,
    robots: jax.Array,
    indices: jax.Array,
    pos: jax.Array,
) -> DescriptorDB:
    """Scatter B rows at arbitrary (distinct) slot positions ``pos``.

    The mixed-robot analog of :func:`db_insert_block`: a fleet batch
    interleaves robots' streams, so its slots are per-robot-consecutive but
    globally non-contiguous — one batched scatter per DB array replaces B
    sequential :func:`db_insert` calls. Caller guarantees every ``pos`` is
    in-range and distinct (runtime/fleet.FleetMapper enforces per-robot
    capacity before dispatching a batch).
    """
    B = indices.shape[0]
    return DescriptorDB(
        descriptors=db.descriptors.at[pos].set(
            descriptors.astype(db.descriptors.dtype)
        ),
        keys=db.keys.at[pos].set(keys.astype(db.keys.dtype)),
        robot=db.robot.at[pos].set(
            jnp.broadcast_to(jnp.asarray(robots, jnp.int32), (B,))
        ),
        index=db.index.at[pos].set(indices.astype(jnp.int32)),
        count=db.count + B,
    )


class Match(NamedTuple):
    """Result of a loop-closure query.

    ``found``: bool scalar. ``db_pos``: global DB position of the match.
    ``robot``/``index``: owner decoding of the match (the reference's
    global→(robot, key) mapping, ``include/distributedMapping.h:1280-1291``).
    ``distance``: family-specific descriptor distance of the accepted match.
    ``yaw``: estimated relative yaw (rad) where the family provides one
    (Scan Context ``include/descriptor.h:1752-1753``, Iris phase correlation),
    else 0.
    """

    found: jax.Array
    db_pos: jax.Array
    robot: jax.Array
    index: jax.Array
    distance: jax.Array
    yaw: jax.Array


def no_match(dtype=jnp.float32) -> Match:
    return Match(
        found=jnp.array(False),
        db_pos=jnp.array(-1, jnp.int32),
        robot=jnp.array(-1, jnp.int32),
        index=jnp.array(-1, jnp.int32),
        distance=jnp.array(jnp.inf, dtype),
        yaw=jnp.array(0.0, dtype),
    )


def candidate_mask(
    db: DescriptorDB,
    query_robot: jax.Array | int,
    query_index: jax.Array | int,
    mode: str,
    exclude_recent: int,
) -> jax.Array:
    """Validity mask over DB slots for a retrieval query.

    ``mode='intra'``: same robot only, excluding the most recent
    ``exclude_recent`` keyframes (reference ``NUM_EXCLUDE_RECENT``,
    ``include/descriptor.h:1314,1684-1696``).
    ``mode='inter'``: other robots only (reference inter-detect searches other
    robots' DBs when the query is its own, ``include/descriptor.h:1150-1250``).
    """
    # occupancy by marker, not count: slot-addressed multi-robot inserts
    # leave holes in row order (robot r occupies rows r*K..r*K+count_r)
    valid = db.index >= 0
    same = db.robot == query_robot
    if mode == "intra":
        not_recent = db.index < (query_index - exclude_recent)
        return valid & same & not_recent
    elif mode == "inter":
        return valid & ~same
    else:
        raise ValueError(f"unknown mode {mode!r}")


def topk_by_key(
    db_keys: jax.Array,
    query_key: jax.Array,
    mask: jax.Array,
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """k nearest DB entries by L2 key distance (masked). Returns (d2, pos)."""
    d2 = jnp.sum((db_keys - query_key[None, :]) ** 2, axis=-1)
    d2 = jnp.where(mask, d2, jnp.inf)
    neg, pos = jax.lax.top_k(-d2, k)
    return -neg, pos

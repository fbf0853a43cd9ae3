"""Checkpoint / resume for the full SLAM session state.

The reference has **no checkpointing** (write-only trajectory exports,
SURVEY §5); a crashed robot loses its map. Here the complete
:class:`MapperState` pytree (keyframe DB, descriptor DB, factor graph, loop
bookkeeping) plus the host-side cursor state round-trips through a single
compressed npz — also the multi-host restart story: every robot checkpoints
independently and resumes mid-session.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3
from .mapper import Mapper
from .state import MapperState


def _flatten_state(state: MapperState) -> dict[str, np.ndarray]:
    leaves, treedef = jax.tree_util.tree_flatten(state)
    return {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}


def save(mapper: Mapper, path: str) -> None:
    """Write a checkpoint (atomic: tmp + rename).

    The snapshot is taken under the mapper's state lock so a bus-thread
    peer ingest can't land between the state capture and the host-side
    cursor capture (``_frames_seen``/``_keyframes``/``_evicted`` must
    describe the same state the arrays do). Only the REFERENCE captures
    happen under the lock — the state pytree is immutable, so the
    device-to-host copy (long at multi-MB
    state sizes) runs after release instead of stalling every
    add_frame/peer ingest behind it (code-review r5).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with mapper._state_lock:
        state = mapper.state                 # immutable pytree reference
        meta, extra = _capture_meta(mapper)
    arrays = _flatten_state(state)
    arrays.update(extra)
    tmp = path + ".tmp"
    np.savez_compressed(tmp, __meta__=json.dumps(meta), **arrays)
    # np.savez appends .npz to names lacking it
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def _capture_meta(mapper: Mapper) -> tuple[dict, dict]:
    """(meta, extra_arrays): the host-side snapshot. Caller holds the
    state lock. The fleet staged-keyframe arrays (at most a batch of
    pending frames) do materialize here; the multi-MB MapperState copy
    is what save() defers past the lock."""
    with mapper._pending_loops_lock:  # serve thread appends concurrently
        pending = list(mapper._pending_server_loops)
    extra: dict = {}
    meta = {
        "version": 1,
        "robot": mapper.robot,
        "frames_seen": mapper._frames_seen,
        "keyframes": mapper._keyframes,
        "last_kf_pose": (
            None
            if mapper._last_kf_pose is None
            else np.asarray(se3.to_matrix(mapper._last_kf_pose)).tolist()
        ),
        "verify_key": np.asarray(mapper._verify_key).tolist(),
        "evicted": {
            str(r): [
                {
                    "index": e["index"],
                    "stamp": e["stamp"],
                    "pose": np.asarray(e["pose"]).tolist(),
                }
                for e in lst
            ]
            for r, lst in mapper._evicted.items()
        },
        # factors verified on the serve path but not yet drained into the
        # device queue (see Mapper._pending_server_loops) — a crash between
        # serve and drain must not lose the server-side factor copy
        "pending_server_loops": [
            [int(a), int(b), np.asarray(T).tolist(), float(nz)]
            for a, b, T, nz in pending
        ],
    }
    # FleetMapper adds host-side serving state: per-robot keyframe gates,
    # the verification RNG key, AND any keyframes staged (accepted by the
    # gate) but not yet processed by step(). Without the staged frames a
    # checkpoint taken between add_robot_frame() and step() would lose
    # them permanently: the restored gate (already advanced past them)
    # rejects a re-feed of the same frames.
    if hasattr(mapper, "_fleet_last_pose"):
        meta["fleet_last_pose"] = {
            str(r): np.asarray(se3.to_matrix(p)).tolist()
            for r, p in mapper._fleet_last_pose.items()
        }
        meta["fleet_key"] = np.asarray(mapper._fleet_key).tolist()
        staged = mapper._fleet_staged
        meta["fleet_staged_n"] = len(staged)
        if staged:
            extra["staged_robot"] = np.asarray(
                [s[0] for s in staged], np.int32
            )
            extra["staged_R"] = np.stack(
                [np.asarray(s[1].R) for s in staged]
            )
            extra["staged_t"] = np.stack(
                [np.asarray(s[1].t) for s in staged]
            )
            extra["staged_xyz"] = np.stack(
                [np.asarray(s[2].xyz) for s in staged]
            )
            extra["staged_mask"] = np.stack(
                [np.asarray(s[2].mask) for s in staged]
            )
            extra["staged_stamp"] = np.asarray(
                [s[3] for s in staged], np.float64
            )
    return meta, extra


def load(mapper: Mapper, path: str) -> Mapper:
    """Restore a checkpoint into an existing (same-config) Mapper."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        if meta["version"] != 1:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        leaves, treedef = jax.tree_util.tree_flatten(mapper.state)
        new_leaves = []
        for i, old in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if arr.shape != old.shape:
                raise ValueError(
                    f"checkpoint/config shape mismatch at leaf {i}: "
                    f"{arr.shape} vs {old.shape} — was the config changed?"
                )
            new_leaves.append(jnp.asarray(arr))
        mapper.state = jax.tree_util.tree_unflatten(treedef, new_leaves)
    mapper._frames_seen = meta["frames_seen"]
    mapper._keyframes = meta["keyframes"]
    if meta["last_kf_pose"] is not None:
        T = jnp.asarray(meta["last_kf_pose"], jnp.float32)
        mapper._last_kf_pose = se3.from_matrix(T)
    else:
        mapper._last_kf_pose = None
    mapper._verify_key = jnp.asarray(meta["verify_key"], jnp.uint32)
    # conservative: the crash may have interrupted an unqueried inter
    # detection — let the first spin_once after resume re-dispatch it
    mapper._inter_dirty = True
    with mapper._pending_loops_lock:
        mapper._pending_server_loops = [
            (int(a), int(b), np.asarray(T, np.float64), float(nz))
            for a, b, T, nz in meta.get("pending_server_loops", [])
        ]
    mapper._evicted = {
        int(r): [
            {
                "index": e["index"],
                "stamp": e["stamp"],
                "pose": np.asarray(e["pose"]),
            }
            for e in lst
        ]
        for r, lst in meta.get("evicted", {}).items()
    }
    if hasattr(mapper, "_fleet_last_pose") and "fleet_last_pose" in meta:
        mapper._fleet_last_pose = {
            int(r): se3.from_matrix(jnp.asarray(T, jnp.float32))
            for r, T in meta["fleet_last_pose"].items()
        }
        mapper._fleet_key = jnp.asarray(meta["fleet_key"], jnp.uint32)
        n_staged = int(meta.get("fleet_staged_n", 0))
        mapper._fleet_staged = []
        mapper._staged_per_robot = {}
        if n_staged:
            with np.load(path, allow_pickle=False) as data:
                robots = data["staged_robot"]
                Rm, tm = data["staged_R"], data["staged_t"]
                xyzs, masks = data["staged_xyz"], data["staged_mask"]
                stamps = data["staged_stamp"]
            from ..ops import pointcloud as pc

            for k in range(n_staged):
                r = int(robots[k])
                mapper._fleet_staged.append(
                    (
                        r,
                        se3.Pose(jnp.asarray(Rm[k]), jnp.asarray(tm[k])),
                        pc.Cloud(jnp.asarray(xyzs[k]), jnp.asarray(masks[k])),
                        float(stamps[k]),
                    )
                )
                mapper._staged_per_robot[r] = (
                    mapper._staged_per_robot.get(r, 0) + 1
                )
    return mapper

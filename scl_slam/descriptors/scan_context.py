"""Scan Context descriptor.

Capability parity with the reference's ``scan_context_descriptor``
(``include/descriptor.h:1304-1801``):

- 20x60 polar max-height image (``makeScancontext``, ``descriptor.h:1404-1461``)
- ring key = row means (``descriptor.h:1463-1475``), sector key = column means
  (``descriptor.h:1477-1489``)
- rotation-aligned matching: column-wise cosine distance minimized over
  sector shifts (``distDirectSC`` ``descriptor.h:1513-1536``,
  ``distanceBtnScanContext`` ``descriptor.h:1538-1569``)
- retrieval: k nearest ring keys, then full descriptor distance over the
  candidates (``descriptor.h:1613-1756``)

Redesign: instead of the reference's per-candidate loop with a
pruned shift search (``SEARCH_RATIO=0.1``), the full (candidates x shifts)
distance volume is computed as **one einsum** over column-normalized
descriptors — a matmul-shaped op that runs as one matmul, so pruning would
only slow it down. KD-trees are replaced by masked top-k (see base.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.pointcloud import Cloud, polar_bins, scatter_max_image
from . import base


@dataclass(frozen=True)
class ScanContextConfig:
    """Defaults mirror reference ``include/descriptor.h:1307-1330``."""

    num_rings: int = 20
    num_sectors: int = 60
    max_radius: float = 80.0
    lidar_height: float = 1.65   # added to z so ground is ~0 (descriptor.h:1431)
    num_candidates: int = 10
    exclude_recent: int = 100    # NUM_EXCLUDE_RECENT (intra only)
    distance_threshold: float = 0.14
    max_bin_points: int = 0      # see config.ScanContextParams


class ScanContext(NamedTuple):
    """Encoded keyframe: image [R, S], ring key [R], sector key [S]."""

    image: jax.Array
    ring_key: jax.Array
    sector_key: jax.Array


def make(cloud: Cloud, cfg: ScanContextConfig) -> ScanContext:
    """Encode one cloud -> Scan Context (reference ``descriptor.h:1404-1489``)."""
    n = cloud.xyz.shape[0]
    if 0 < cfg.max_bin_points < n:
        # static stride decimation of the scan-ordered cloud (azimuth-
        # uniform per beam). NOT free: see config.ScanContextParams — at
        # KITTI density 16k-of-115k shifts a borderline true revisit from
        # 0.086 to 0.117 against the 0.14 gate. Off (0) by default.
        stride = -(-n // cfg.max_bin_points)
        cloud = Cloud(cloud.xyz[::stride], cloud.mask[::stride])
    ring, sector, valid = polar_bins(
        cloud.xyz, cloud.mask, cfg.num_rings, cfg.num_sectors, cfg.max_radius
    )
    z = cloud.xyz[..., 2] + cfg.lidar_height
    # dense-compare binning (ops.pointcloud.scatter_max_image)
    img = scatter_max_image(
        z, ring, sector, valid, cfg.num_rings, cfg.num_sectors, init=0.0
    )
    ring_key = jnp.mean(img, axis=1)
    sector_key = jnp.mean(img, axis=0)
    return ScanContext(img, ring_key, sector_key)


def _column_normalize(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """L2-normalize columns; returns (normalized, col_valid mask)."""
    norm = jnp.linalg.norm(img, axis=-2)
    valid = norm > 1e-9
    return img / jnp.maximum(norm, 1e-9)[..., None, :], valid


def shifted_cosine_distance(
    query: jax.Array, candidates: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Min-over-shifts column-wise cosine distance.

    query [R, S]; candidates [K, R, S]. Returns (dist [K], best_shift [K]).

    Matches ``distanceBtnScanContext`` semantics (``descriptor.h:1538-1569``):
    dist(s) = mean over columns of (1 - cos) between query column j+s and
    candidate column j, skipping empty columns; minimized over all S shifts.
    Implemented as one [S*R, S] x [K, R, S] contraction (matmul-shaped).
    """
    R, S = query.shape
    qn, qv = _column_normalize(query)          # [R, S], [S]
    cn, cv = _column_normalize(candidates)     # [K, R, S], [K, S]

    # build all circular shifts of the query: shifted[s, :, j] = qn[:, (j+s)%S]
    j = jnp.arange(S)
    s = jnp.arange(S)
    cols = (j[None, :] + s[:, None]) % S       # [S, S]
    q_shift = qn[:, cols]                      # [R, S_shift, S_col]
    q_shift = jnp.transpose(q_shift, (1, 0, 2))  # [S_shift, R, S_col]
    qv_shift = qv[cols]                        # [S_shift, S_col]

    # cos similarity per (shift, candidate, column): sum over rings
    cos = jnp.einsum("srj,krj->skj", q_shift, cn)  # [S, K, S_col]
    both = qv_shift[:, None, :] & cv[None, :, :]   # [S, K, S_col]
    n_cols = jnp.maximum(jnp.sum(both, axis=-1), 1)
    dist = jnp.sum(jnp.where(both, 1.0 - cos, 0.0), axis=-1) / n_cols  # [S, K]
    best_shift = jnp.argmin(dist, axis=0)          # [K]
    best = jnp.min(dist, axis=0)
    return best, best_shift


def shift_to_yaw(shift: jax.Array, num_sectors: int) -> jax.Array:
    """Sector shift -> relative yaw in radians (reference ``descriptor.h:1752``)."""
    half = num_sectors // 2
    signed = jnp.where(shift > half, shift - num_sectors, shift)
    return signed.astype(jnp.float32) * (2.0 * jnp.pi / num_sectors)


def make_db(capacity: int, cfg: ScanContextConfig) -> base.DescriptorDB:
    return base.make_db(
        capacity, (cfg.num_rings, cfg.num_sectors), cfg.num_rings
    )


def insert(
    db: base.DescriptorDB, sc: ScanContext, robot, index, pos=None
) -> base.DescriptorDB:
    return base.db_insert(db, sc.image, sc.ring_key, robot, index, pos)


def from_wire(values: jax.Array, cfg: ScanContextConfig) -> ScanContext:
    """Decode a broadcast float vector (the reference's

    ``saveDescriptorAndKey`` wire format: the flat image,
    ``descriptor.h:1604-1611``)."""
    img = values.reshape(cfg.num_rings, cfg.num_sectors)
    return ScanContext(img, jnp.mean(img, axis=1), jnp.mean(img, axis=0))


def to_wire(sc: ScanContext) -> jax.Array:
    return sc.image.reshape(-1)


@partial(jax.jit, static_argnames=("cfg", "mode"))
def query_batch(
    db: base.DescriptorDB,
    images: jax.Array,
    ring_keys: jax.Array,
    query_robots: jax.Array,
    query_indices: jax.Array,
    cfg: ScanContextConfig,
    mode: str = "intra",
) -> base.Match:
    """Vmapped multi-query retrieval: B queries against the DB in one call.

    The serving-throughput path (BASELINE loop-closure queries/s): candidate
    ring-key distances for all queries form one [B, N] matrix and the
    shifted-distance stage batches over (B x K) candidates as one contraction.
    """

    def one(img, key, robot, index):
        sc = ScanContext(img, key, jnp.mean(img, axis=0))
        return query(db, sc, robot, index, cfg, mode)

    return jax.vmap(one)(images, ring_keys, query_robots, query_indices)


@partial(jax.jit, static_argnames=("cfg", "mode"))
def query(
    db: base.DescriptorDB,
    sc: ScanContext,
    query_robot: jax.Array,
    query_index: jax.Array,
    cfg: ScanContextConfig,
    mode: str = "intra",
) -> base.Match:
    """Two-stage loop detection (reference ``descriptor.h:1613-1756``).

    Stage 1: ``num_candidates`` nearest ring keys (masked top-k).
    Stage 2: full shifted cosine distance on the candidates; accept the best
    if below ``distance_threshold``.
    """
    mask = base.candidate_mask(db, query_robot, query_index, mode, cfg.exclude_recent)
    _, pos = base.topk_by_key(db.keys, sc.ring_key, mask, cfg.num_candidates)
    cand_imgs = db.descriptors[pos]                    # [K, R, S]
    dist, shift = shifted_cosine_distance(sc.image, cand_imgs)
    # invalidate candidates that came from masked-out slots (top_k padding)
    cand_ok = mask[pos]
    dist = jnp.where(cand_ok, dist, jnp.inf)
    best = jnp.argmin(dist)
    best_pos = pos[best]
    best_dist = dist[best]
    found = best_dist < cfg.distance_threshold
    return base.Match(
        found=found,
        db_pos=jnp.where(found, best_pos, -1),
        robot=jnp.where(found, db.robot[best_pos], -1),
        index=jnp.where(found, db.index[best_pos], -1),
        distance=best_dist,
        yaw=shift_to_yaw(shift[best], cfg.num_sectors),
    )

"""GRSD and FPFH global descriptors.

Capability parity with the reference's minor descriptor families:

- ``grsd_descriptor`` (``include/descriptor.h:38-196``): PCL normal
  estimation + 21-bin Global Radius-based Surface Descriptor; inter-robot
  detection = 1-NN with L2 threshold 160 (``:116-167``); intra detection is
  an empty stub upstream (``:111-114``) — implemented properly here.
- ``fpfh_descriptor`` (``include/descriptor.h:253-460``): single-point SPFH
  signature at the cloud centroid, 3 x 11 bins = 33-D (``:308-365``);
  inter detection 1-NN with L2 threshold 100 (``:381-432``).

Design: per-point neighborhoods via tiled brute-force k-NN (matmul-shaped
distance blocks), local surface classification from covariance eigenvalues,
everything vmapped; no KD-trees, no sequential point loops.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.pointcloud import Cloud, estimate_normals
from . import base


# ---------------------------------------------------------------------------
# GRSD
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GRSDConfig:
    num_bins: int = 21        # reference GRSD histogram size
    knn: int = 16
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 160.0   # reference L2 gate (descriptor.h:158)
    # voxel grid (reference: pcl::GRSDEstimation with setRadiusSearch(2.0),
    # descriptor.h:90 — PCL's GRSD voxel width equals the search radius)
    voxel_width: float = 2.0
    extent_xy: float = 80.0   # grid covers [-extent, extent) per axis
    extent_z: float = 16.0
    rsd_subdiv: int = 5       # alpha bins of the RSD radius estimate


# RSD surface-class thresholds (meters) — the published GRSD categorization
# regimes (plane / cylinder / noise / sphere / rim) over local min/max
# surface radius, as used by the PCL estimator the reference instantiates.
_PLANE_RADIUS = 0.2        # radius cap: r -> min(r, cap); a plane has r = cap
_MIN_RADIUS_PLANE = 0.1    # r_min above this => plane
_MIN_RADIUS_CYLINDER = 0.175   # r_max above this (r_min small) => cylinder
_MAX_RADIUS_NOISE = 0.015  # r_min below this => noise/corner
_MAX_MIN_RADIUS_DIFF = 0.05    # r_max - r_min below this => sphere
_CLS_EMPTY = 5             # free-space voxel class (6 classes -> 21 pairs)


class GRSD(NamedTuple):
    descriptor: jax.Array    # [21]


def _knn_normals(cloud: Cloud, k: int):
    """Block-tiled brute-force k-NN + covariance normals, returning BOTH the

    neighbor indices and the unit normals (``ops.pointcloud.estimate_normals``
    recomputes the k-NN internally; RSD needs the same neighborhoods again,
    so share one pass — the k-NN is the dominant cost of the descriptor)."""
    xyz = jnp.where(cloud.mask[:, None], cloud.xyz, 1e6)
    n = cloud.capacity

    def block(q):
        d2 = (
            jnp.sum(q * q, -1, keepdims=True) - 2.0 * q @ xyz.T + jnp.sum(xyz * xyz, -1)
        )
        _, idx = jax.lax.top_k(-d2, k)
        return idx

    idx = jax.lax.map(block, xyz.reshape(max(1, n // 512), -1, 3)).reshape(n, k)
    nbrs = xyz[idx]
    mean = jnp.mean(nbrs, axis=1, keepdims=True)
    c = nbrs - mean
    cov = jnp.einsum("nki,nkj->nij", c, c) / k
    _, vecs = jnp.linalg.eigh(cov)
    normals = vecs[..., 0]                      # smallest-eigenvector [N, 3]
    return idx, nbrs, normals


def _rsd_radii(cloud: Cloud, cfg: GRSDConfig):
    """Per-point RSD min/max surface radius (the radius-based estimate GRSD

    is named for): for each neighbor pair, the arc model ``d = r * alpha``
    (``d`` = point distance, ``alpha`` = angle between normals) gives a
    local radius estimate; binning alpha into ``rsd_subdiv`` bins and taking
    the max distance per bin (PCL ``computeRSD`` semantics) yields robust
    min/max radii as the extrema of ``d_max(alpha)/alpha`` over bins, capped
    at the plane radius. Returns r_min [N], r_max [N], valid [N].
    """
    idx, nbrs, normals = _knn_normals(cloud, cfg.knn)
    xyz = jnp.where(cloud.mask[:, None], cloud.xyz, 1e6)
    diff = nbrs - xyz[:, None, :]
    d = jnp.linalg.norm(diff, axis=-1)                       # [N, k]
    # angle between normals; abs() folds the normal sign ambiguity
    cosang = jnp.abs(jnp.einsum("ni,nki->nk", normals, normals[idx]))
    alpha = jnp.arccos(jnp.clip(cosang, 0.0, 1.0))           # [0, pi/2]
    valid = (
        cloud.mask[:, None]
        & cloud.mask[idx]
        & (d > 1e-6)
        & (d <= cfg.voxel_width)
    )
    nb = cfg.rsd_subdiv
    b = jnp.clip(
        (alpha / (jnp.pi / 2.0) * nb).astype(jnp.int32), 0, nb - 1
    )                                                        # [N, k]
    onehot = jax.nn.one_hot(b, nb, dtype=d.dtype)            # [N, k, nb]
    w = valid[..., None].astype(d.dtype) * onehot
    dmax = jnp.max(
        jnp.where(w > 0, d[..., None], -jnp.inf), axis=1
    )                                                        # [N, nb]
    bin_ok = jnp.any(w > 0, axis=1)                          # [N, nb]
    centers = (jnp.arange(nb, dtype=d.dtype) + 0.5) * (jnp.pi / 2.0) / nb
    r = jnp.minimum(dmax / centers, _PLANE_RADIUS)           # [N, nb]
    r_min = jnp.min(jnp.where(bin_ok, r, jnp.inf), axis=1)
    r_max = jnp.max(jnp.where(bin_ok, r, -jnp.inf), axis=1)
    pt_ok = jnp.any(bin_ok, axis=1) & cloud.mask
    return (
        jnp.where(pt_ok, r_min, 0.0),
        jnp.where(pt_ok, r_max, 0.0),
        pt_ok,
    )


# the 13 positive-lexicographic voxel offsets = half the 26-neighborhood
# (each unordered neighbor pair counted exactly once)
_OFFSETS = tuple(
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
    if (dz, dy, dx) > (0, 0, 0)
)


def grsd_make(cloud: Cloud, cfg: GRSDConfig) -> GRSD:
    """Radius-based voxel-transition GRSD (reference ``descriptor.h:57-100``:

    ``pcl::GRSDEstimation`` with normals + ``setRadiusSearch(2.0)``).
    Device pipeline, all static shapes:

    1. per-point RSD min/max surface radius (:func:`_rsd_radii`);
    2. scatter-mean the radii onto a dense ``voxel_width`` grid and classify
       each occupied voxel into {noise, plane, cylinder, sphere, rim}; free
       voxels are class 5;
    3. histogram the class transitions between each voxel and its
       26-neighborhood (13 unique directions, ``jnp.roll`` + boundary masks)
       into the 21 unordered class pairs, skipping free-free pairs.

    The descriptor is the raw transition-count histogram (PCL's
    ``GRSDSignature21`` is likewise unnormalized), compared downstream with
    the reference's absolute L2 gate.
    """
    r_min, r_max, ok = _rsd_radii(cloud, cfg)
    w = cfg.voxel_width
    gx = int(round(2.0 * cfg.extent_xy / w))
    gz = int(round(2.0 * cfg.extent_z / w))
    xyz = cloud.xyz
    ix = jnp.floor((xyz[:, 0] + cfg.extent_xy) / w).astype(jnp.int32)
    iy = jnp.floor((xyz[:, 1] + cfg.extent_xy) / w).astype(jnp.int32)
    iz = jnp.floor((xyz[:, 2] + cfg.extent_z) / w).astype(jnp.int32)
    inb = (
        (ix >= 0) & (ix < gx) & (iy >= 0) & (iy < gx)
        & (iz >= 0) & (iz < gz) & ok
    )
    flat = jnp.where(inb, (ix * gx + iy) * gz + iz, 0)
    nv = gx * gx * gz
    wgt = inb.astype(xyz.dtype)
    cnt = jnp.zeros((nv,), xyz.dtype).at[flat].add(wgt)
    s_min = jnp.zeros((nv,), xyz.dtype).at[flat].add(r_min * wgt)
    s_max = jnp.zeros((nv,), xyz.dtype).at[flat].add(r_max * wgt)
    occ = cnt > 0
    vmin = s_min / jnp.maximum(cnt, 1.0)
    vmax = s_max / jnp.maximum(cnt, 1.0)
    cls = jnp.select(
        [
            ~occ,
            vmin > _MIN_RADIUS_PLANE,                       # plane
            vmax > _MIN_RADIUS_CYLINDER,                    # cylinder
            vmin < _MAX_RADIUS_NOISE,                       # noise/corner
            (vmax - vmin) < _MAX_MIN_RADIUS_DIFF,           # sphere
        ],
        [_CLS_EMPTY, 1, 2, 0, 3],
        default=4,                                          # rim/edge
    ).reshape(gx, gx, gz)
    occ3 = occ.reshape(gx, gx, gz)

    # triangular unordered-pair index over 6 classes -> 21 bins:
    # idx(a<=b) = a*6 - a*(a-1)/2 + (b-a)
    def tri(a, b):
        lo = jnp.minimum(a, b)
        hi = jnp.maximum(a, b)
        return lo * 6 - (lo * (lo - 1)) // 2 + (hi - lo)

    ax_idx = [
        jnp.arange(gx)[:, None, None],
        jnp.arange(gx)[None, :, None],
        jnp.arange(gz)[None, None, :],
    ]
    dims = (gx, gx, gz)
    hist = jnp.zeros((cfg.num_bins,), xyz.dtype)
    for off in _OFFSETS:
        nb_cls = jnp.roll(cls, tuple(-o for o in off), axis=(0, 1, 2))
        nb_occ = jnp.roll(occ3, tuple(-o for o in off), axis=(0, 1, 2))
        inbounds = jnp.ones((), bool)
        for a, o in enumerate(off):
            if o == 1:
                inbounds = inbounds & (ax_idx[a] < dims[a] - 1)
            elif o == -1:
                inbounds = inbounds & (ax_idx[a] > 0)
        keep = inbounds & (occ3 | nb_occ)      # skip free-free pairs
        pair = tri(cls, nb_cls).reshape(-1)
        hist = hist.at[pair].add(keep.reshape(-1).astype(xyz.dtype))
    return GRSD(hist)


# ---------------------------------------------------------------------------
# FPFH (single-point SPFH at centroid, as the reference uses it)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FPFHConfig:
    num_bins: int = 11        # bins per angle (3 angles -> 33-D)
    knn: int = 64             # neighborhood of the centroid point
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 100.0   # reference L2 gate (descriptor.h:397)


class FPFH(NamedTuple):
    descriptor: jax.Array    # [33]


def fpfh_make(cloud: Cloud, cfg: FPFHConfig) -> FPFH:
    """SPFH of the point nearest the centroid (reference computes

    ``computePointSPFHSignature`` at the centroid index, ``descriptor.h:341-353``):
    Darboux-frame angle histograms (alpha, phi, theta) between the center
    normal and each neighbor normal."""
    normals = estimate_normals(cloud, k=16)
    xyz = jnp.where(cloud.mask[:, None], cloud.xyz, 1e6)
    w = cloud.mask.astype(xyz.dtype)
    centroid = jnp.sum(xyz * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    center_idx = jnp.argmin(jnp.sum((xyz - centroid) ** 2, axis=-1))
    p_c = xyz[center_idx]
    n_c = normals[center_idx]

    d2 = jnp.sum((xyz - p_c) ** 2, axis=-1)
    _, nbr = jax.lax.top_k(-d2, cfg.knn)
    p_k = xyz[nbr]
    n_k = normals[nbr]

    # Darboux frame at the centroid point
    diff = p_k - p_c
    dist = jnp.maximum(jnp.linalg.norm(diff, axis=-1), 1e-9)
    u = n_c
    v = jnp.cross(diff / dist[:, None], u[None, :])
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    wv = jnp.cross(u[None, :], v)
    alpha = jnp.einsum("kj,kj->k", v, n_k)                    # in [-1, 1]
    phi = jnp.einsum("j,kj->k", u, diff / dist[:, None])      # in [-1, 1]
    theta = jnp.arctan2(
        jnp.einsum("kj,kj->k", wv, n_k), jnp.einsum("j,kj->k", u, n_k)
    )  # in [-pi, pi]

    valid = cloud.mask[nbr] & (nbr != center_idx)

    def hist(vals, lo, hi):
        b = jnp.clip(
            ((vals - lo) / (hi - lo) * cfg.num_bins).astype(jnp.int32),
            0, cfg.num_bins - 1,
        )
        return jnp.zeros((cfg.num_bins,), xyz.dtype).at[b].add(
            valid.astype(xyz.dtype)
        )

    h = jnp.concatenate(
        [hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0), hist(theta, -jnp.pi, jnp.pi)]
    )
    # percentage normalization (PCL convention: bins sum to 100 per angle)
    h = h / jnp.maximum(jnp.sum(valid), 1) * 100.0
    return FPFH(h)


# ---------------------------------------------------------------------------
# shared DB plumbing (both are plain-vector descriptors)
# ---------------------------------------------------------------------------


def make_db(capacity: int, dim: int) -> base.DescriptorDB:
    return base.make_db(capacity, (dim,), dim)


def insert(db: base.DescriptorDB, desc: jax.Array, robot, index, pos=None) -> base.DescriptorDB:
    return base.db_insert(db, desc, desc, robot, index, pos)


@partial(jax.jit, static_argnames=("num_candidates", "exclude_recent", "threshold", "mode"))
def vector_query(
    db: base.DescriptorDB,
    desc: jax.Array,
    query_robot: jax.Array,
    query_index: jax.Array,
    num_candidates: int,
    exclude_recent: int,
    threshold: float,
    mode: str = "inter",
) -> base.Match:
    """1-NN detection with an absolute L2 gate (reference nanoflann searches,

    ``descriptor.h:116-167, 381-432``)."""
    mask = base.candidate_mask(db, query_robot, query_index, mode, exclude_recent)
    d2, pos = base.topk_by_key(db.keys, desc, mask, num_candidates)
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    dist = jnp.where(mask[pos], dist, jnp.inf)
    best = jnp.argmin(dist)
    best_pos = pos[best]
    found = dist[best] < threshold
    return base.Match(
        found=found,
        db_pos=jnp.where(found, best_pos, -1),
        robot=jnp.where(found, db.robot[best_pos], -1),
        index=jnp.where(found, db.index[best_pos], -1),
        distance=dist[best],
        yaw=jnp.zeros(()),
    )

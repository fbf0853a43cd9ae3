"""M2DP descriptor.

Capability parity with the reference's ``m2dp_descriptor``
(``include/descriptor.h:1803-2049``): PCA-align the cloud, project onto
4 azimuth x 16 elevation view planes, accumulate a 16-theta x 8-rho polar
histogram per view (``GetSignatureMatrix`` ``descriptor.h:1865-1931``,
``histogram2d`` ``:1948-1979``), SVD the 64x128 signature, concatenate the
first left (64) and right (128) singular vectors into a 192-D descriptor
(``makeAndSaveDescriptorAndKey`` ``:1821-1863``).

Note: the reference's ``detect*`` methods are **empty stubs**
(``descriptor.h:1998-2006``) — loop detection never worked for this family
upstream. Here detection is implemented properly: top-k by L2 over the 192-D
vector (the descriptor is its own retrieval key).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.pointcloud import Cloud
from . import base


@dataclass(frozen=True)
class M2DPConfig:
    num_t: int = 16          # theta bins (reference numT)
    num_r: int = 8           # rho bins (reference numR)
    num_p: int = 4           # azimuth view angles (reference numP)
    num_q: int = 16          # elevation view angles (reference numQ)
    max_rho: float = 80.0
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 0.25   # L2 on unit-norm 192-vectors


class M2DP(NamedTuple):
    descriptor: jax.Array   # [num_p*num_q + num_t*num_r] = 192-D


def _pca_align(xyz: jax.Array, mask: jax.Array) -> jax.Array:
    """Center and rotate into principal axes (reference uses pcl::PCA,

    ``descriptor.h:1824-1860``). Sign convention: each axis is flipped so the
    dominant side of the data is positive, making the frame deterministic."""
    w = mask.astype(xyz.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(xyz * w[:, None], axis=0) / n
    c = (xyz - mean) * w[:, None]
    cov = c.T @ c / n
    _, vecs = jnp.linalg.eigh(cov)            # ascending
    axes = vecs[:, ::-1]                      # principal first
    proj = c @ axes
    # deterministic signs: majority of mass positive per axis
    sign = jnp.where(jnp.sum(proj**3, axis=0) < 0, -1.0, 1.0)
    return proj * sign[None, :]


def make(cloud: Cloud, cfg: M2DPConfig) -> M2DP:
    aligned = _pca_align(cloud.xyz, cloud.mask)
    w = cloud.mask.astype(aligned.dtype)

    # view directions: azimuth p in [0, pi/num_p ...], elevation q
    p_angles = jnp.pi * jnp.arange(cfg.num_p) / cfg.num_p
    q_angles = jnp.pi / 2 * jnp.arange(1, cfg.num_q + 1) / cfg.num_q
    az, el = jnp.meshgrid(p_angles, q_angles, indexing="ij")
    az, el = az.reshape(-1), el.reshape(-1)    # [V]
    # plane normal for each view
    normals = jnp.stack(
        [jnp.cos(el) * jnp.cos(az), jnp.cos(el) * jnp.sin(az), jnp.sin(el)], -1
    )  # [V, 3]

    def signature_row(nrm):
        # project to the plane orthogonal to nrm; in-plane basis (u, v)
        ref = jnp.where(jnp.abs(nrm[2]) < 0.9, jnp.array([0.0, 0.0, 1.0]),
                        jnp.array([1.0, 0.0, 0.0]))
        u = jnp.cross(nrm, ref)
        u = u / jnp.linalg.norm(u)
        v = jnp.cross(nrm, u)
        pu = aligned @ u
        pv = aligned @ v
        rho = jnp.sqrt(pu * pu + pv * pv)
        theta = jnp.arctan2(pv, pu)
        tb = jnp.clip(
            ((theta + jnp.pi) / (2 * jnp.pi) * cfg.num_t).astype(jnp.int32),
            0, cfg.num_t - 1,
        )
        # sqrt-spaced rho bins (reference concentrates bins near center)
        rb = jnp.clip(
            (jnp.sqrt(jnp.minimum(rho / cfg.max_rho, 1.0)) * cfg.num_r).astype(jnp.int32),
            0, cfg.num_r - 1,
        )
        flat = tb * cfg.num_r + rb
        hist = jnp.zeros((cfg.num_t * cfg.num_r,), aligned.dtype).at[flat].add(w)
        return hist / jnp.maximum(jnp.sum(w), 1.0)

    A = jax.vmap(signature_row)(normals)       # [V, num_t*num_r] = [64, 128]
    U, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    d = jnp.concatenate([U[:, 0], Vt[0, :]])   # [64 + 128] = 192
    # sign-normalize (SVD sign ambiguity)
    d = d * jnp.where(jnp.sum(U[:, 0]) < 0, -1.0, 1.0)
    return M2DP(d / jnp.maximum(jnp.linalg.norm(d), 1e-9))


def make_db(capacity: int, cfg: M2DPConfig) -> base.DescriptorDB:
    dim = cfg.num_p * cfg.num_q + cfg.num_t * cfg.num_r
    return base.make_db(capacity, (dim,), dim)


def insert(db: base.DescriptorDB, d: M2DP, robot, index, pos=None) -> base.DescriptorDB:
    return base.db_insert(db, d.descriptor, d.descriptor, robot, index, pos)


def to_wire(d: M2DP) -> jax.Array:
    return d.descriptor


def from_wire(values: jax.Array, cfg: M2DPConfig) -> M2DP:
    return M2DP(values)


@partial(jax.jit, static_argnames=("cfg", "mode"))
def query(
    db: base.DescriptorDB,
    d: M2DP,
    query_robot: jax.Array,
    query_index: jax.Array,
    cfg: M2DPConfig,
    mode: str = "intra",
) -> base.Match:
    mask = base.candidate_mask(db, query_robot, query_index, mode, cfg.exclude_recent)
    d2, pos = base.topk_by_key(db.keys, d.descriptor, mask, cfg.num_candidates)
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    dist = jnp.where(mask[pos], dist, jnp.inf)
    best = jnp.argmin(dist)
    best_pos = pos[best]
    found = dist[best] < cfg.distance_threshold
    return base.Match(
        found=found,
        db_pos=jnp.where(found, best_pos, -1),
        robot=jnp.where(found, db.robot[best_pos], -1),
        index=jnp.where(found, db.index[best_pos], -1),
        distance=dist[best],
        yaw=jnp.zeros(()),  # M2DP is rotation-invariant; no yaw estimate
    )

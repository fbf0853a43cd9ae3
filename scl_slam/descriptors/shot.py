"""Global SHOT-style descriptor.

The reference declares a ``shot_descriptor`` whose methods are all empty
(``include/descriptor.h:198-251`` — a never-finished skeleton). For
capability completeness this module provides a working global variant of the
SHOT idea (Signature of Histograms of OrienTations, Tombari et al.): build a
local reference frame from the cloud's covariance, partition space into
azimuth x elevation x radial bins around the centroid, and histogram
cos(angle between point normal and the LRF z-axis) per bin.

Design: normals via the batched covariance eigensolver in
:mod:`..ops.pointcloud`, binning via scatter-add, retrieval via the shared
vector-query path (1-NN + L2 gate) like GRSD/FPFH.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.pointcloud import Cloud, estimate_normals
from . import base
from .geometric import make_db, insert, vector_query  # shared DB plumbing

__all__ = ["SHOTConfig", "SHOT", "shot_make", "make_db", "insert", "vector_query"]


@dataclass(frozen=True)
class SHOTConfig:
    azimuth_bins: int = 4
    elevation_bins: int = 2
    radial_bins: int = 2
    cos_bins: int = 5          # orientation histogram per spatial bin
    max_radius: float = 80.0
    knn: int = 16
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 50.0

    @property
    def dim(self) -> int:
        return self.azimuth_bins * self.elevation_bins * self.radial_bins * self.cos_bins


class SHOT(NamedTuple):
    descriptor: jax.Array


def shot_make(cloud: Cloud, cfg: SHOTConfig) -> SHOT:
    normals = estimate_normals(cloud, k=cfg.knn)
    w = cloud.mask.astype(cloud.xyz.dtype)
    n_pts = jnp.maximum(jnp.sum(w), 1.0)
    centroid = jnp.sum(cloud.xyz * w[:, None], axis=0) / n_pts
    centered = cloud.xyz - centroid

    # LRF from covariance eigenvectors (z = least-variance direction)
    cov = jnp.einsum("ni,n,nj->ij", centered, w, centered) / n_pts
    _, vecs = jnp.linalg.eigh(cov)
    z_axis, y_axis, x_axis = vecs[:, 0], vecs[:, 1], vecs[:, 2]
    # disambiguate signs by majority mass
    x_axis = x_axis * jnp.where(jnp.sum((centered @ x_axis) ** 3) < 0, -1.0, 1.0)
    z_axis = z_axis * jnp.where(jnp.sum((normals @ z_axis)) < 0, -1.0, 1.0)
    y_axis = jnp.cross(z_axis, x_axis)

    px = centered @ x_axis
    py = centered @ y_axis
    pz = centered @ z_axis
    r = jnp.sqrt(px * px + py * py + pz * pz)

    az = jnp.arctan2(py, px)
    a_bin = jnp.clip(
        ((az + jnp.pi) / (2 * jnp.pi) * cfg.azimuth_bins).astype(jnp.int32),
        0, cfg.azimuth_bins - 1,
    )
    el = pz / jnp.maximum(r, 1e-6)  # in [-1, 1]
    e_bin = jnp.clip(
        ((el + 1.0) * 0.5 * cfg.elevation_bins).astype(jnp.int32),
        0, cfg.elevation_bins - 1,
    )
    r_bin = jnp.clip(
        (jnp.sqrt(jnp.minimum(r / cfg.max_radius, 1.0)) * cfg.radial_bins).astype(
            jnp.int32
        ),
        0, cfg.radial_bins - 1,
    )
    cos_n = normals @ z_axis  # [-1, 1]
    c_bin = jnp.clip(
        ((cos_n + 1.0) * 0.5 * cfg.cos_bins).astype(jnp.int32), 0, cfg.cos_bins - 1
    )

    flat = (
        ((a_bin * cfg.elevation_bins + e_bin) * cfg.radial_bins + r_bin)
        * cfg.cos_bins
        + c_bin
    )
    valid = cloud.mask & (r < cfg.max_radius)
    hist = jnp.zeros((cfg.dim,), cloud.xyz.dtype).at[
        jnp.where(valid, flat, 0)
    ].add(jnp.where(valid, 1.0, 0.0))
    hist = hist / jnp.maximum(jnp.sum(valid), 1) * 100.0
    return SHOT(hist)

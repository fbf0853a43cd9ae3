"""Point-cloud primitives: fixed-capacity clouds, transform, voxel downsample,

polar binning, normal estimation — the JAX replacements for the PCL
operations the reference links (``VoxelGrid``, ``transformPointCloud``,
``NormalEstimation``; reference ``include/distributedMapping.h:234-253,340-349``,
``include/descriptor.h:69-92``).

Design stance (SURVEY §7): clouds are statically-shaped ``[N, 3]`` arrays with
a validity mask / count; variable-size PCL vectors become padded tensors so
every op is jittable and batchable.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

PAD_VALUE = 1e6  # sentinel coordinate for invalid points (far outside any map)


class Cloud(NamedTuple):
    """Fixed-capacity point cloud: xyz [N, 3], validity mask [N] (bool)."""

    xyz: jax.Array
    mask: jax.Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> jax.Array:
        return jnp.sum(self.mask, axis=-1)


def from_points(xyz: jax.Array, capacity: int) -> Cloud:
    """Pad (or stride-subsample) a host array [M, 3] to a fixed-capacity Cloud.

    Over-capacity scans are subsampled with a uniform stride, NOT truncated:
    LiDAR scans arrive in beam/azimuth order, so truncation silently drops
    entire beams or sweep sectors (a 115k-point scan at 65536 capacity would
    lose half the field of view — every descriptor built from it collapses),
    while a stride keeps full coverage at reduced density.
    """
    xyz = fit_capacity(xyz, capacity)
    m = xyz.shape[0]
    out = jnp.full((capacity, 3), PAD_VALUE, dtype=jnp.float32)
    out = out.at[:m].set(xyz[:m].astype(jnp.float32))
    mask = jnp.arange(capacity) < m
    return Cloud(out, mask)


def fit_capacity(xyz, capacity: int):
    """Host-side uniform-stride subsample of [M, 3] down to <= capacity

    points (identity when it already fits) — the over-capacity policy of
    :func:`from_points`, shared by the batched replay staging loops."""
    m = xyz.shape[0]
    if m <= capacity:
        return xyz
    step = -(-m // capacity)  # ceil
    return xyz[::step][:capacity]


def transform(cloud: Cloud, R: jax.Array, t: jax.Array) -> Cloud:
    """Rigid transform of a cloud; invalid points stay at the sentinel."""
    xyz = jnp.einsum("...ij,...nj->...ni", R, cloud.xyz) + t[..., None, :]
    xyz = jnp.where(cloud.mask[..., None], xyz, PAD_VALUE)
    return Cloud(xyz, cloud.mask)


def voxel_downsample(cloud: Cloud, leaf: float, out_capacity: int | None = None) -> Cloud:
    """Voxel-grid downsample keeping one representative point per voxel.

    JAX replacement for ``pcl::VoxelGrid`` (reference
    ``include/distributedMapping.h:340-349``). Instead of centroid averaging
    (dynamic group-by), keeps the point closest to its voxel center. Voxels
    are grouped **exactly** by sorting a packed int32 voxel key (no hash
    collisions), then a segment-min over group ids picks the representative.
    Deterministic, world-grid-aligned, fully static shapes.
    """
    n = cloud.capacity
    out_capacity = out_capacity or n
    inv_leaf = 1.0 / leaf
    # Center on the masked mean so voxel coords fit a PACKED int32 key
    # (11+11+8 bits: +-1024 cells in x/y, +-128 in z around the centroid —
    # +-204 m / +-25 m at leaf 0.2). One single-key sort is cheaper than a
    # 3-key lexsort. Points outside the packed range
    # (far beyond any LiDAR return of interest) are treated as invalid.
    w = cloud.mask.astype(cloud.xyz.dtype)
    mean = jnp.sum(cloud.xyz * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    # quantize the origin to the leaf grid so voxel boundaries remain
    # world-aligned (mask-independent), merely shifted by whole cells
    origin = jnp.floor(mean * inv_leaf) * leaf
    vox = jnp.floor((cloud.xyz - origin) * inv_leaf).astype(jnp.int32)
    in_range = (
        (jnp.abs(vox[:, 0]) < 1024)
        & (jnp.abs(vox[:, 1]) < 1024)
        & (jnp.abs(vox[:, 2]) < 128)
    )
    valid = cloud.mask & in_range
    packed = (
        (vox[:, 0] + 1024) * (2048 * 256)
        + (vox[:, 1] + 1024) * 256
        + (vox[:, 2] + 128)
    )
    big = jnp.int32(2**30)
    packed = jnp.where(valid, packed, big)
    # mask used downstream must match the packed validity
    cloud = Cloud(jnp.where(valid[:, None], cloud.xyz, PAD_VALUE), valid)
    vox = jnp.where(valid[:, None], vox, big)

    # exact grouping: single-key sort, consecutive-difference group ids
    order = jnp.argsort(packed)
    sv = packed[order]
    new_group = sv != jnp.roll(sv, 1)
    new_group = new_group.at[0].set(True)
    gid_sorted = jnp.cumsum(new_group) - 1  # [n], group id per sorted slot
    # scatter group ids back to original point order
    gid = jnp.zeros(n, jnp.int32).at[order].set(gid_sorted.astype(jnp.int32))

    # representative = closest point to its voxel center (segment-min, exact;
    # vox coords are centroid-relative, so add the mean back)
    center = (vox.astype(jnp.float32) + 0.5) * leaf + origin
    d2 = jnp.sum((cloud.xyz - center) ** 2, axis=-1)
    d2 = jnp.where(cloud.mask, d2, jnp.inf)
    min_d2 = jnp.full((n,), jnp.inf, dtype=jnp.float32).at[gid].min(d2)
    idxs = jnp.arange(n, dtype=jnp.int32)
    is_rep = (d2 <= min_d2[gid]) & cloud.mask
    first_idx = jnp.full((n,), n, dtype=jnp.int32).at[gid].min(
        jnp.where(is_rep, idxs, n)
    )
    is_rep = is_rep & (idxs == first_idx[gid])

    # Compact representatives to the front. When representatives exceed
    # out_capacity, truncation must be spatially UNBIASED — input order or
    # voxel order would drop whole regions (scan order is azimuthal; voxel
    # order is x-major). Order reps by a voxel-coordinate hash instead:
    # truncation then keeps a uniform pseudo-random subset of voxels.
    h = (
        vox[:, 0] * 73856093 ^ vox[:, 1] * 19349663 ^ vox[:, 2] * 83492791
    ).astype(jnp.uint32) >> 1  # keep positive as int32
    sort_key = jnp.where(is_rep, h.astype(jnp.int32), jnp.int32(2**31 - 1))
    order2 = jnp.argsort(sort_key, stable=True)
    take = order2[:out_capacity]
    new_mask = is_rep[take]
    new_xyz = jnp.where(new_mask[:, None], cloud.xyz[take], PAD_VALUE)
    return Cloud(new_xyz, new_mask)


def voxel_downsample_hash(
    cloud: Cloud,
    leaf: float,
    out_capacity: int,
    hash_slots: int = 1 << 15,
    predecimate_factor: int = 4,
) -> Cloud:
    """Approximate voxel downsample in ONE scatter pass — the ingest fast path.

    The exact :func:`voxel_downsample` groups voxels by a full argsort of the
    packed voxel key: at 64k points that sort is the single most expensive op
    in keyframe ingestion. Here each point scatter-mins a packed
    (quantized-distance-to-voxel-center, point-index) word into a
    ``hash_slots``-entry table keyed by a voxel hash; occupied slots are then
    compacted by cumsum-scatter. No sort anywhere.

    Approximation: distinct voxels that collide in the hash table merge (one
    representative survives). At 32k slots and LiDAR-typical 15-25k occupied
    voxels the loss is a few percent of points, spatially uncorrelated —
    immaterial for keyframe STORAGE (ICP targets / submaps); descriptors are
    built from the raw scan (see runtime/mapper.py::_ingest). Compaction
    order is hash order, preserving the 'prefix slice = uniform spatial
    subsample' property downstream code relies on.

    Requires ``cloud.capacity <= 65536`` (index packs into 16 bits);
    falls back to the exact path above otherwise.
    """
    n = cloud.capacity
    if n > 65536:
        return voxel_downsample(cloud, leaf, out_capacity)
    # Pre-decimation: the scatter-min below costs per input point and
    # the output is capped at ``out_capacity`` voxels regardless of
    # input size, so feeding it many times that many points only buys
    # scatter time. A static stride slice down to ``predecimate_factor x
    # out_capacity`` points keeps occupied-voxel count comfortably above the
    # cap (LiDAR scans put 4x points over >2x-the-cap voxels) while cutting
    # the dominant scatter cost proportionally. Stride decimation is an
    # unbiased spatial subsample, so representative quality is unchanged up
    # to in-voxel jitter that the leaf already quantizes away. Disable with
    # ``predecimate_factor=0``.
    target = predecimate_factor * out_capacity
    if predecimate_factor > 0 and n > 2 * target:
        stride = n // target
        cloud = Cloud(cloud.xyz[::stride], cloud.mask[::stride])
        n = cloud.capacity
    inv_leaf = 1.0 / leaf
    w = cloud.mask.astype(cloud.xyz.dtype)
    mean = jnp.sum(cloud.xyz * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    origin = jnp.floor(mean * inv_leaf) * leaf
    vox = jnp.floor((cloud.xyz - origin) * inv_leaf).astype(jnp.int32)
    in_range = (
        (jnp.abs(vox[:, 0]) < 1024)
        & (jnp.abs(vox[:, 1]) < 1024)
        & (jnp.abs(vox[:, 2]) < 128)
    )
    valid = cloud.mask & in_range
    h = (
        (vox[:, 0] * 73856093 ^ vox[:, 1] * 19349663 ^ vox[:, 2] * 83492791)
        & 0x7FFFFFFF
    ) % hash_slots
    center = (vox.astype(jnp.float32) + 0.5) * leaf + origin
    d2 = jnp.sum((cloud.xyz - center) ** 2, axis=-1)
    # pack (15-bit quantized d2 | 16-bit index); d2 <= 3/4 leaf^2 in-voxel
    q = jnp.minimum(d2 * (32767.0 / (0.75 * leaf * leaf)), 32767.0).astype(
        jnp.int32
    )
    sentinel = jnp.int32(0x7FFFFFFF)
    packed = (q << 16) | jnp.arange(n, dtype=jnp.int32)
    packed = jnp.where(valid, packed, sentinel)
    best = jnp.full((hash_slots,), sentinel, jnp.int32).at[h].min(packed)
    occupied = best != sentinel
    rep_idx = best & 0xFFFF
    # sort-free compaction: cumsum positions; non-kept lanes scatter out of
    # bounds and are dropped (positions of kept lanes are unique by cumsum)
    pos = jnp.cumsum(occupied.astype(jnp.int32)) - 1
    ok = occupied & (pos < out_capacity)
    tgt = jnp.where(ok, pos, out_capacity)
    out_idx = jnp.zeros((out_capacity,), jnp.int32).at[tgt].set(
        rep_idx, mode="drop"
    )
    out_mask = jnp.arange(out_capacity) < jnp.sum(ok)
    xyz = jnp.where(out_mask[:, None], cloud.xyz[out_idx], PAD_VALUE)
    return Cloud(xyz, out_mask)


def stride_permute_downsample(cloud: Cloud, out_capacity: int) -> Cloud:
    """Constant-time storage downsample: static-stride slice composed with a
    fixed coprime permutation — ONE gather, no sort, no scatter.

    The ingest fast-fast path (~0.05 ms at 64k -> 4096 vs 0.68 ms for the
    hash voxel grid): LiDAR scans arrive in azimuthal sweep order, so a
    stride slice is an azimuth-uniform subsample; composing with the
    multiplicative permutation ``i -> (a*i + c) mod m`` (odd ``a``, power-of-
    two ``m`` => bijective) makes every PREFIX of the stored cloud an
    equally-spaced azimuthal subsample — the same prefix-slice-uniformity
    property downstream code relies on from hash ordering (submap gathers,
    ICP source slices, global-map budgets).

    Unlike the voxel paths this does NO deduplication: near-field density
    survives, matching raw-scan statistics instead of the reference's
    VoxelGrid-equalized clouds. Acceptable for ICP targets/sources (1-NN
    correspondence is density-insensitive; fitness gates shift by < the
    synthetic-test margins — see tests/test_pipeline.py), not for
    descriptor construction (which uses the raw scan anyway).

    Requires the input mask to be a dense prefix (the ``from_points``
    contract, true of every ingest source); the scrambled indices are scaled
    into ``[0, count)`` so the output is itself fully dense — every gathered
    row is a valid point even when the scan underfills its capacity. When
    ``count < out_capacity`` (degenerate scans) points repeat, which is
    harmless to 1-NN correspondence and masked statistics.
    """
    m = out_capacity
    i = jnp.arange(m, dtype=jnp.uint32)
    # golden-ratio-ish odd multiplier: i -> (a*i+1) mod m is a bijection for
    # power-of-two m (odd a), a near-uniform scramble otherwise
    a = (2654435761 % m) | 1
    scramble = (jnp.uint32(a) * i + 1) % jnp.uint32(m)
    count = cloud.count().astype(jnp.uint32)
    # scale into the valid prefix; uint32 product < 2^32 for m, count <= 2^16
    idx = ((scramble * count) // jnp.uint32(m)).astype(jnp.int32)
    ok = count > 0
    mask = jnp.broadcast_to(ok, (m,))
    xyz = jnp.where(mask[:, None], cloud.xyz[idx], PAD_VALUE)
    return Cloud(xyz, mask)


def polar_bins(
    xyz: jax.Array,
    mask: jax.Array,
    num_rings: int,
    num_sectors: int,
    max_radius: float,
    min_radius: float = 0.0,
):
    """Ring/sector bin indices for each point (Scan Context style binning,

    reference ``include/descriptor.h:1404-1461``). Returns
    ``(ring_idx, sector_idx, valid)`` with out-of-range points masked out."""
    x, y = xyz[..., 0], xyz[..., 1]
    r = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(y, x)  # [-pi, pi]
    frac = (theta + jnp.pi) / (2.0 * jnp.pi)  # [0, 1)
    sector = jnp.clip((frac * num_sectors).astype(jnp.int32), 0, num_sectors - 1)
    ring = jnp.clip(
        ((r - min_radius) / (max_radius - min_radius) * num_rings).astype(jnp.int32),
        0,
        num_rings - 1,
    )
    valid = mask & (r < max_radius) & (r >= min_radius)
    return ring, sector, valid


def scatter_max_image(
    values: jax.Array,
    ring: jax.Array,
    sector: jax.Array,
    valid: jax.Array,
    num_rings: int,
    num_sectors: int,
    init: float = 0.0,
    block: int = 2048,
) -> jax.Array:
    """Bin-wise max image [num_rings, num_sectors] from per-point values.

    For the small bin counts of Scan Context (20x60 = 1200) this is a
    blockwise DENSE reduction instead of a scatter-max: compare each
    point's flat bin index against all bins ([bins, block] select + max — a
    vectorized reduction), then max across blocks. Falls back to scatter
    when bins * block work would exceed the pointwise-scatter cost (e.g.
    Iris's 28800 bins).
    """
    nb = num_rings * num_sectors
    n = values.shape[-1]
    flat_idx = jnp.where(valid, ring * num_sectors + sector, nb).astype(jnp.int32)
    vals = jnp.where(valid, values, init)
    # dense path is a win when bins*n compare-ops beat ~serialized n updates;
    # empirically the crossover is around 4k bins for 2k-point blocks
    if nb * min(block, n) <= (1 << 23) and n % block == 0 and n >= block:
        bins = jnp.arange(nb, dtype=jnp.int32)[:, None]  # [nb, 1]

        def one_block(carry, inp):
            bi, bv = inp  # [block], [block]
            hit = bins == bi[None, :]                     # [nb, block]
            m = jnp.max(jnp.where(hit, bv[None, :], init), axis=1)
            return jnp.maximum(carry, m), None

        img0 = jnp.full((nb,), init, dtype=values.dtype)
        img, _ = jax.lax.scan(
            one_block,
            img0,
            (flat_idx.reshape(-1, block), vals.reshape(-1, block)),
        )
        return img.reshape(num_rings, num_sectors)
    img = jnp.full((nb + 1,), init, dtype=values.dtype)
    img = img.at[flat_idx].max(vals)
    return img[:-1].reshape(num_rings, num_sectors)


def estimate_normals(cloud: Cloud, k: int = 16, block: int = 512) -> jax.Array:
    """Per-point normals from the k-NN neighborhood covariance eigenvector.

    JAX replacement for ``pcl::NormalEstimation`` (reference
    ``include/descriptor.h:69-78,318-330``): tiled brute-force k-NN (distance
    matrix blocks stay matmul-shaped) + smallest-eigenvector of the 3x3
    neighborhood covariance via closed-form symmetric eigendecomposition.
    Returns [N, 3] unit normals (zeros for invalid points).
    """
    xyz = jnp.where(cloud.mask[:, None], cloud.xyz, PAD_VALUE)
    n = cloud.capacity

    def block_knn(q):  # q: [B, 3]
        d2 = (
            jnp.sum(q * q, axis=-1, keepdims=True)
            - 2.0 * q @ xyz.T
            + jnp.sum(xyz * xyz, axis=-1)[None, :]
        )
        _, idx = jax.lax.top_k(-d2, k)
        return idx  # [B, k]

    idx = jax.lax.map(
        block_knn, xyz.reshape(n // block, block, 3)
    ).reshape(n, k)
    nbrs = xyz[idx]  # [N, k, 3]
    mean = jnp.mean(nbrs, axis=1, keepdims=True)
    centered = nbrs - mean
    cov = jnp.einsum("nki,nkj->nij", centered, centered) / k
    # smallest eigenvector of symmetric 3x3
    _, vecs = jnp.linalg.eigh(cov)
    normal = vecs[..., 0]  # eigenvectors sorted ascending
    # orient towards viewpoint (origin), PCL convention
    flip = jnp.sum(normal * (-xyz), axis=-1) < 0
    normal = jnp.where(flip[:, None], -normal, normal)
    return jnp.where(cloud.mask[:, None], normal, 0.0)

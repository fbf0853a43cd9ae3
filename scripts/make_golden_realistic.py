#!/usr/bin/env python
"""Regenerate tests/golden/realistic_sc.npz.

Mirrors tests/test_realistic_proxy.py::TestGoldenDescriptors exactly
(same scene seed, circuit, config, frame indices, scan seeds). Run on CPU
(the suite's platform) whenever io/lidar_sim.py's scene generation changes.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from scl_slam.descriptors import scan_context as sc
from scl_slam.io.lidar_sim import LidarSim, UrbanScene
from scl_slam.ops import pointcloud as pc
from scl_slam.runtime.state import scan_context_config

from tests.test_realistic_proxy import RAW_CAP, ref_default_cfg  # noqa: E402


def main():
    scene = UrbanScene(seed=7, blocks=1, block_size=40.0)
    sim = LidarSim(scene, n_azimuth=1800)
    lap = scene.circuit(step=1.0)
    scc = scan_context_config(ref_default_cfg())
    out = {}
    for i in (5, 100, 150):
        scan = sim.scan_at(lap[i], seed=i)
        d = sc.make(pc.from_points(scan, RAW_CAP), scc)
        out[f"n_points_{i}"] = np.int64(scan.shape[0])
        out[f"image_{i}"] = np.asarray(d.image)
        out[f"ring_key_{i}"] = np.asarray(d.ring_key)
        print(f"frame {i}: {scan.shape[0]} pts, "
              f"image mean {out[f'image_{i}'].mean():.4f}")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "golden", "realistic_sc.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()

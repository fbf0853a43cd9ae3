"""Offline run figure (io/viz.py) — the L8 operator-surface artifact.

Reference analog: rviz layouts + loop MarkerArray
(``include/distributedMapping.h:1388-1447``); here the CLI emits one PNG
per run instead (headless deployment).
"""
import numpy as np
import pytest

from scl_slam.io import viz


def _ring(n=40, r=10.0):
    t = np.linspace(0, 2 * np.pi, n)
    P = np.tile(np.eye(4), (n, 1, 1))
    P[:, 0, 3] = r * np.cos(t)
    P[:, 1, 3] = r * np.sin(t)
    return P


def test_save_run_figure_full(tmp_path):
    path = str(tmp_path / "traj.png")
    loops = [
        {"pi": np.array([10.0, 0.0, 0.0]), "pj": np.array([10.1, 0.1, 0.0]),
         "kind": "intra"},
        {"pi": np.array([0.0, 10.0, 0.0]), "pj": np.array([0.2, 9.9, 0.0]),
         "kind": "inter"},
    ]
    out = viz.save_run_figure(
        path,
        _ring(),
        odom=_ring(r=10.5),
        gt=_ring(r=9.9),
        loops=loops,
        map_points=np.random.RandomState(0).randn(5000, 3) * 12,
        title="test run",
        subtitle="ATE 0.1 m",
    )
    assert out == path
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(data) > 10_000  # a real rendered figure, not a blank stub


def test_save_run_figure_minimal(tmp_path):
    # est only — no odom/gt/loops/map (e.g. a dataset without ground truth)
    path = str(tmp_path / "min.png")
    out = viz.save_run_figure(path, _ring(n=5))
    assert out == path
    assert open(path, "rb").read()[:8] == b"\x89PNG\r\n\x1a\n"


def test_save_run_figure_empty_est(tmp_path):
    # zero keyframes should still produce a file, not crash the run report
    path = str(tmp_path / "empty.png")
    out = viz.save_run_figure(path, np.zeros((0, 4, 4)))
    assert out == path


def test_save_fleet_figure(tmp_path):
    path = str(tmp_path / "fleet.png")
    trajs = {"a": _ring(), "b": _ring(r=10.5)}
    gts = {"a": _ring(r=9.9), "b": _ring(r=10.4)}
    loops = [
        {"pi": np.array([10.0, 0.0, 0.0]), "pj": np.array([10.4, 0.2, 0.0]),
         "kind": "inter"},
        {"pi": np.array([0.0, 10.0, 0.0]), "pj": np.array([0.1, 9.9, 0.0]),
         "kind": "intra"},
    ]
    out = viz.save_fleet_figure(
        path, trajs, gts=gts, loops=loops,
        map_points=np.random.RandomState(1).randn(3000, 3) * 12,
        title="fleet", subtitle="2 robots")
    assert out == path
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 10_000


def test_save_fleet_figure_empty(tmp_path):
    path = str(tmp_path / "fleet_empty.png")
    out = viz.save_fleet_figure(path, {})
    assert out == path

import numpy as np

from scl_slam.io import export as eio
from scl_slam.utils import timing
from scl_slam.utils.logging import get_logger


class TestTimers:
    def test_accumulates(self):
        t = timing.Timers()
        for _ in range(3):
            with t.time("stage_a"):
                pass
        rep = t.report()
        assert rep["stage_a"]["count"] == 3
        assert "stage_a" in t.pretty()


class TestExport:
    def test_ply_roundtrip_header(self, tmp_path):
        pts = np.random.RandomState(0).uniform(-5, 5, (50, 3)).astype(np.float32)
        p = str(tmp_path / "map.ply")
        eio.save_ply(p, pts)
        head = open(p).read().splitlines()
        assert head[0] == "ply"
        assert "element vertex 50" in head[2]

    def test_pcd_roundtrip(self, tmp_path):
        pts = np.random.RandomState(1).uniform(-5, 5, (20, 3)).astype(np.float32)
        p = str(tmp_path / "poses.pcd")
        eio.save_pcd(p, pts)
        back = eio.load_pcd(p)
        np.testing.assert_allclose(back, pts, atol=1e-5)

    def test_loop_constraints_json(self, tmp_path):
        p = str(tmp_path / "loops.json")
        eio.save_loop_constraints(
            p, [{"i": 1, "j": 5, "pi": [0, 0, 0], "pj": [1, 1, 1], "kind": "intra", "sigma": 0.1}]
        )
        import json

        data = json.load(open(p))
        assert len(data["loop_constraints"]) == 1


class TestLogging:
    def test_logger_levels(self, capsys):
        log = get_logger("test")
        log.info("hello")
        log.debug("hidden at info level")

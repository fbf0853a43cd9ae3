import os

import pytest

from scl_slam.config import DescriptorType, SlamConfig, load_config

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


class TestConfig:
    def test_defaults_valid(self):
        cfg = SlamConfig()
        assert cfg.number_of_robots == 1

    def test_validation(self):
        with pytest.raises(ValueError):
            SlamConfig(number_of_robots=0)
        with pytest.raises(ValueError):
            SlamConfig(number_of_robots=2, robot_id=5)
        with pytest.raises(ValueError):
            SlamConfig(robot_name="ab")

    def test_load_dict(self):
        cfg = load_config(
            {"descriptor_type": "lidar_iris", "loop": {"icp_iterations": 7}}
        )
        assert cfg.descriptor_type == DescriptorType.LIDAR_IRIS
        assert cfg.loop.icp_iterations == 7

    def test_unknown_key_rejected(self):
        with pytest.raises(KeyError):
            load_config({"not_a_key": 1})

    @pytest.mark.parametrize(
        "name", ["kitti_velodyne.yaml", "two_robot_iris.yaml", "four_robot_cityscale.yaml"]
    )
    def test_shipped_configs_load(self, name):
        cfg = load_config(os.path.join(CONFIG_DIR, name))
        assert isinstance(cfg, SlamConfig)

"""Test configuration: force the CPU backend with a virtual 8-device mesh.

The suite runs on the CPU; sharding tests run against
``--xla_force_host_platform_device_count=8`` (the analog of the reference's
single-machine multi-robot simulation via namespaced rosbag replay,
reference ``launch/test_distributed_loop.launch:34-58``). Tests that need a
GPU carry the ``gpu`` marker and skip here; ``chip_smoke.py`` covers the
same code on the card.

``jax_platforms`` is set through jax.config (not the environment) so it
holds even when jax was imported before this file ran.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# JAX_PLATFORMS, when set, picks the backend (the ``gpu``-marked tests run
# on the card with JAX_PLATFORMS=cuda); otherwise the suite runs on the CPU
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# the persistent compile cache is placed by the package (scl_slam/__init__)
import scl_slam  # noqa: E402,F401


import numpy as _np
import pytest as _pytest


@_pytest.fixture(scope="session")
def mesh8():
    """8-device mesh; fails loudly if the virtual-device flag didn't take."""
    from jax.sharding import Mesh

    devs = _np.array(jax.devices()[:8])
    assert len(devs) == 8, "tests require the 8-device CPU mesh (see conftest)"
    return Mesh(devs, ("shard",))


@_pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skips ``@pytest.mark.gpu`` tests unless JAX's backend is a GPU.
    Decided at run time, inside the fixture, so every xdist worker
    collects the same tests."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        _pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on the card)")

"""scl_slam — a collaborative LiDAR SLAM back end in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
thisparticle/scl_slam (ROS1/C++/GTSAM): place-recognition descriptors
(Scan Context, LiDAR-Iris, M2DP, GRSD, FPFH), loop-closure retrieval and
geometric verification (ICP / RANSAC+SVD), and single- & multi-robot
pose-graph optimization — all as batched, statically-shaped, jittable
functions that run on one GPU or shard over several.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# The GPU runs f32 matmuls in TF32 by default, which keeps ~3 decimal
# digits. At SLAM coordinate scales (tens of meters) that is enough error
# in squared distances to randomize nearest-neighbor correspondences, and
# enough normal-equation error to break Cholesky in the GN solver.
# Geometry correctness is the product here; the matmuls on our hot paths
# are tiny-K contractions where full precision costs almost nothing.
_jax.config.update("jax_default_matmul_precision", "highest")

# persistent compile cache: JAX reads JAX_COMPILATION_CACHE_DIR itself when
# it is set; otherwise the cache lives at one fixed directory inside the
# checkout (listed in .gitignore), so every process of this checkout finds
# what an earlier one compiled.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .config import DescriptorType, SlamConfig, load_config  # noqa: E402
from .geometry import Pose  # noqa: E402

__all__ = ["SlamConfig", "DescriptorType", "load_config", "Pose", "Mapper"]


def __getattr__(name):
    # lazy: runtime pulls in the full stack; keep bare import light
    if name == "Mapper":
        from .runtime import Mapper

        return Mapper
    raise AttributeError(name)

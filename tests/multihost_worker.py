"""Worker for the 2-process distributed-solve test (spawned by

test_multihost.py). Each process owns 2 virtual CPU devices; the factor-
sharded GN solve runs over the 4-device global mesh with Gloo collectives —
the mechanical validation of the multi-host pod path (SURVEY §7.9)."""
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax

jax.config.update("jax_platforms", "cpu")

from scl_slam.parallel import multihost

multihost.init(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)

import jax.numpy as jnp
import numpy as np

from scl_slam.geometry import se3, so3
from scl_slam.graph import factors as F
from scl_slam.parallel import sharded

mesh = multihost.make_mesh(("shard",))
assert jax.device_count() == 2 * nproc

# deterministic toy problem, identical in every process
n, cap = 16, 32
key = jax.random.PRNGKey(0)
angles = jnp.linspace(0, 2 * jnp.pi, n, endpoint=False)
gt_R = so3.from_euler(
    jnp.stack([jnp.zeros(n), jnp.zeros(n), angles + jnp.pi / 2], -1)
)
gt_t = jnp.stack([10 * jnp.cos(angles), 10 * jnp.sin(angles), jnp.zeros(n)], -1)
gt = se3.Pose(gt_R, gt_t)

g = F.make_graph(64, 4)
g = F.add_prior(g, 0, se3.index(gt, 0), [1e3] * 6)
noisy = []
for k in range(n - 1):
    z = se3.between(se3.index(gt, k), se3.index(gt, k + 1))
    noise = se3.exp(jax.random.normal(jax.random.fold_in(key, k), (6,)) * 0.02)
    zn = se3.compose(z, noise)
    noisy.append(zn)
    g = F.add_between(g, k, k + 1, zn, [50.0] * 6)
g = F.add_between(
    g, n - 1, 0, se3.between(se3.index(gt, n - 1), se3.index(gt, 0)), [1e3] * 6
)

poses = [se3.index(gt, 0)]
for z in noisy:
    poses.append(se3.compose(poses[-1], z))
init_n = se3.stack(poses)
init = se3.Pose(
    jnp.concatenate([init_n.R, jnp.broadcast_to(jnp.eye(3), (cap - n, 3, 3))]),
    jnp.concatenate([init_n.t, jnp.zeros((cap - n, 3))]),
)

out_poses, chis = sharded.sharded_solve(mesh, "shard", g, init, gn_iters=5, cg_iters=32)
chi_first, chi_last = float(chis[0]), float(chis[-1])
err = float(jnp.linalg.norm(out_poses.t[:n] - gt.t, axis=-1).mean())
print(f"RESULT pid={pid} chi_first={chi_first:.4f} chi_last={chi_last:.4f} err={err:.4f}",
      flush=True)
assert chi_last < chi_first * 0.5
assert err < 0.5  # shape fixed by loops; absolute error ~ odometry noise level

"""Scan-to-map ICP odometry — the in-framework LIO front end.

The reference's odometry lives in sibling repos (LIO-SAM / FAST-LIO2 /
LIO-Livox, selected by launch arg — reference ``launch/single_ugv.launch:2,8-92``,
SURVEY §2.2): each maintains a local map and registers every deskewed scan
against it. This module is the JAX equivalent of that contract
(IMU-free, like the KITTI odometry benchmark): a fixed-capacity rolling
local map with per-point normals, constant-velocity motion prediction, and
point-to-plane scan-to-map ICP per frame — one jitted update.

Produces the per-frame poses the back end consumes
(``Mapper.add_frame``); accuracy on structured scenes is keyframe-grade
(the back end's loop closures absorb residual drift).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3, so3
from ..ops import deskew as dsk
from ..ops import pointcloud as pc
from ..ops import registration as reg


class OdometryConfig(NamedTuple):
    map_capacity: int = 32768       # rolling local map points
    scan_capacity: int = 4096       # downsampled input scan points
    scan_leaf: float = 0.5
    map_leaf: float = 0.5
    icp_iters: int = 12
    max_corr_dist: float = 2.0
    normal_knn: int = 12
    insert_every: int = 1           # insert scan into the map every N frames
    # motion compensation (ops/deskew.py; reference front ends all deskew,
    # launch/single_ugv.launch:33-39): "none" assumes pre-deskewed input;
    # "const" removes constant-twist motion (prediction- or gyro-seeded);
    # "gyro" uses the gyro-integrated rotation trajectory when samples are
    # provided (falls back to "const" otherwise). Per-point times come
    # from azimuth (one revolution per sweep).
    deskew: str = "none"
    deskew_clockwise: bool = False  # spin direction for azimuth times


class OdometryState(NamedTuple):
    map_xyz: jax.Array        # [M, 3]
    map_mask: jax.Array       # [M]
    map_normals: jax.Array    # [M, 3]
    pose: se3.Pose            # current sensor pose in odom frame
    prev_pose: se3.Pose       # pose at previous frame (for const-velocity)
    frame: jax.Array          # int32 counter


def make_odometry(cfg: OdometryConfig) -> OdometryState:
    return OdometryState(
        map_xyz=jnp.full((cfg.map_capacity, 3), pc.PAD_VALUE, jnp.float32),
        map_mask=jnp.zeros((cfg.map_capacity,), bool),
        map_normals=jnp.zeros((cfg.map_capacity, 3), jnp.float32),
        pose=se3.identity(),
        prev_pose=se3.identity(),
        frame=jnp.zeros((), jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def odometry_step(
    state: OdometryState,
    xyz: jax.Array,
    mask: jax.Array,
    cfg: OdometryConfig,
    imu_delta_R: jax.Array | None = None,
    gyro: jax.Array | None = None,
    gyro_dt: jax.Array | None = None,
):
    """One frame: deskew, predict, register, and merge into the local map.

    ``imu_delta_R``: optional gyro-preintegrated rotation over the frame
    interval (see :mod:`.imu`) — replaces the rotational part of the
    constant-velocity prediction, which is where that model is weakest.
    ``gyro``/``gyro_dt``: the interval's raw samples ([M, 3] body rates,
    [M] spacings, dt<=0 pads ignored) — subsumes ``imu_delta_R`` (the
    integrated rotation is a byproduct) and additionally drives
    ``deskew="gyro"``'s rotation trajectory, all inside this one program.
    Returns (new_state, pose, fitness).
    """
    # constant-velocity prediction: pose * (prev_pose^-1 * pose); gyro
    # overrides the rotation when available
    vel = se3.between(state.prev_pose, state.pose)
    sample_R = sample_tfrac = None
    if gyro is not None:
        sample_R, sample_tfrac = dsk.gyro_rotation_samples(gyro, gyro_dt)
        if imu_delta_R is None:
            imu_delta_R = sample_R[-1]
    if imu_delta_R is not None:
        vel = se3.Pose(imu_delta_R, vel.t)

    # motion compensation on the RAW scan (before voxel binning: a
    # smeared cloud bins differently), using the predicted sweep motion —
    # the first frame has no motion estimate and skips (vel = identity)
    if cfg.deskew != "none":
        times = dsk.azimuth_sweep_times(xyz, mask, cfg.deskew_clockwise)
        if cfg.deskew == "gyro" and sample_R is not None:
            xyz = dsk.deskew_gyro(
                xyz, mask, times, sample_R, sample_tfrac, vel.t
            )
        else:
            xyz = dsk.deskew_constant_twist(xyz, mask, times, vel)

    scan = pc.voxel_downsample(pc.Cloud(xyz, mask), cfg.scan_leaf, cfg.scan_capacity)

    pred = se3.compose(state.pose, vel)
    pred = se3.Pose(so3.orthonormalize(pred.R), pred.t)

    first = state.frame == 0
    target = pc.Cloud(state.map_xyz, state.map_mask)
    res = reg.icp_point_to_plane(
        scan,
        target,
        state.map_normals,
        init=pred,
        max_iters=cfg.icp_iters,
        max_corr_dist=cfg.max_corr_dist,
    )
    new_pose = se3.Pose(
        jnp.where(first, state.pose.R, res.pose.R),
        jnp.where(first, state.pose.t, res.pose.t),
    )

    # merge scan (in odom frame) into the rolling map: keep newest points,
    # overwrite oldest slots ring-buffer style, then refresh normals for the
    # written span only (cheap: normals of untouched points are unchanged)
    world = se3.transform_points(new_pose, scan.xyz)
    world = jnp.where(scan.mask[:, None], world, pc.PAD_VALUE)
    S = cfg.scan_capacity
    start = (state.frame * S) % cfg.map_capacity
    rows = (start + jnp.arange(S)) % cfg.map_capacity
    do_insert = (state.frame % cfg.insert_every) == 0
    map_xyz = jnp.where(
        do_insert, state.map_xyz.at[rows].set(world), state.map_xyz
    )
    map_mask = jnp.where(
        do_insert, state.map_mask.at[rows].set(scan.mask), state.map_mask
    )

    # normals for newly written points from the updated map
    sub = pc.Cloud(map_xyz, map_mask)
    new_norms = _normals_for_rows(sub, rows, cfg.normal_knn)
    map_normals = jnp.where(
        do_insert, state.map_normals.at[rows].set(new_norms), state.map_normals
    )

    new_state = OdometryState(
        map_xyz=map_xyz,
        map_mask=map_mask,
        map_normals=map_normals,
        pose=new_pose,
        prev_pose=state.pose,
        frame=state.frame + 1,
    )
    return new_state, new_pose, res.fitness


def _normals_for_rows(cloud: pc.Cloud, rows: jax.Array, k: int) -> jax.Array:
    """Normals only for ``rows`` of the map (k-NN covariance eigenvector)."""
    xyz = jnp.where(cloud.mask[:, None], cloud.xyz, pc.PAD_VALUE)
    q = xyz[rows]
    # brute-force k-NN of the row points against the whole map
    def block(qb):
        diff = qb[:, None, :] - xyz[None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        _, idx = jax.lax.top_k(-d2, k)
        return idx

    nb = max(1, q.shape[0] // 512)
    idx = jax.lax.map(block, q.reshape(nb, -1, 3)).reshape(q.shape[0], k)
    nbrs = xyz[idx]
    mean = jnp.mean(nbrs, axis=1, keepdims=True)
    c = nbrs - mean
    cov = jnp.einsum("nki,nkj->nij", c, c) / k
    _, vecs = jnp.linalg.eigh(cov)
    normal = vecs[..., 0]
    # orient towards the sensor (approximately: towards -point direction)
    flip = jnp.sum(normal * (-q), axis=-1) < 0
    return jnp.where(flip[:, None], -normal, normal)


class Odometry:
    """Host-side convenience wrapper."""

    def __init__(self, cfg: OdometryConfig = OdometryConfig()):
        self.cfg = cfg
        self.state = make_odometry(cfg)

    def step(
        self,
        xyz: np.ndarray,
        gyro: np.ndarray | None = None,
        imu_dt: np.ndarray | None = None,
    ) -> tuple[se3.Pose, float]:
        """Register one scan; optional gyro samples (body rates [N,3] with

        per-sample intervals [N]) seed the rotation prediction and, with
        ``cfg.deskew="gyro"``, drive the deskew rotation trajectory —
        integrated inside the same jitted step (no extra dispatch)."""
        cloud = pc.from_points(xyz, self.cfg.scan_capacity * 2)
        g = gdt = None
        if gyro is not None:
            # pad the sample axis to a multiple of 32: real IMU intervals
            # vary sample-to-sample, and each distinct length would
            # otherwise compile a fresh program (dt<=0 pads are ignored)
            g = np.asarray(gyro, np.float32)
            gdt = np.asarray(imu_dt, np.float32)
            m = len(gdt)
            pad = (-m) % 32 if m else 32
            if pad:
                g = np.concatenate([g, np.zeros((pad, 3), np.float32)])
                gdt = np.concatenate([gdt, np.zeros(pad, np.float32)])
            g, gdt = jnp.asarray(g), jnp.asarray(gdt)
        self.state, pose, fitness = odometry_step(
            self.state, cloud.xyz, cloud.mask, self.cfg, None, g, gdt
        )
        return pose, float(fitness)


class ImuFusedOdometry:
    """Full LIO front end: scan-to-map ICP fused with the 15-state IMU
    window smoother (:mod:`..graph.imu_factor`).

    The reference gets this from its LIO-SAM sibling repo (GTSAM
    CombinedImuFactor between keyframes, ``config/dlc_lio_sam_params.yaml:39-70``).
    Per frame:

    1. the interval's gyro samples (bias-corrected with the smoother's
       current estimate) seed the ICP rotation prediction;
    2. scan-to-map point-to-plane ICP registers the scan;
    3. the interval's raw IMU + the ICP relative pose enter the sliding
       window, which re-estimates poses, velocities, and both biases;
    4. the smoothed pose is returned (and the bias feeds step 1 next frame).
    """

    def __init__(
        self,
        cfg: OdometryConfig = OdometryConfig(),
        imu_cfg=None,
        window: int = 8,
        max_samples: int = 64,
        solve_iters: int = 4,
        max_smooth_gap: float = 0.5,
    ):
        from ..graph import imu_factor as IF

        self.odo = Odometry(cfg)
        self.smoother = IF.ImuSmoother(
            window, max_samples, imu_cfg or IF.ImuFactorConfig()
        )
        self.solve_iters = solve_iters
        self.max_smooth_gap = max_smooth_gap
        self._last_pose: se3.Pose | None = None

    def step(
        self,
        xyz: np.ndarray,
        accel: np.ndarray,
        gyro: np.ndarray,
        imu_dt: np.ndarray,
    ) -> tuple[se3.Pose, float, dict]:
        """Register one scan with its interval's IMU samples.

        Returns (smoothed pose, icp fitness, info) where info carries the
        current velocity and bias estimates."""
        sm = self.smoother
        n = min(sm.node_count, sm.window - 1)
        bg = np.asarray(sm.states.bg[max(n - 1, 0)])
        pose, fitness = self.odo.step(
            xyz, gyro=np.asarray(gyro) - bg, imu_dt=imu_dt
        )
        if self._last_pose is None:
            # first frame anchors node 0
            sm.set_node_pose(0, pose.R, pose.t)
            self._last_pose = pose
            return pose, fitness, {"velocity": np.zeros(3), "bg": bg,
                                   "ba": np.asarray(sm.states.ba[0])}
        rel = se3.between(self._last_pose, pose)
        sm.push_interval(accel, gyro, imu_dt, rel)
        n = min(sm.node_count - 1, sm.window - 1)
        sm.set_node_pose(n, pose.R, pose.t)
        # seed the new node's velocity from the ICP pose finite difference
        # (and node 0 on the first interval): without it the solver
        # linearizes at v=0, far outside the GN basin on fast trajectories
        T = float(np.sum(np.maximum(np.asarray(imu_dt), 0.0)))
        if T > 1e-6:
            v_fd = (np.asarray(pose.t) - np.asarray(self._last_pose.t)) / T
            sm.set_node_velocity(n, v_fd)
            if n == 1:
                sm.set_node_velocity(0, v_fd)
        states, _ = sm.solve(gn_iters=self.solve_iters)
        smoothed = se3.Pose(states.R[n], states.p[n])
        # divergence gate: inconsistent IMU (bad calibration, dropped
        # samples) must never be allowed to destroy a good ICP pose
        gap = float(np.linalg.norm(np.asarray(smoothed.t) - np.asarray(pose.t)))
        if gap > self.max_smooth_gap:
            smoothed = pose
        self._last_pose = pose  # ICP chain continues from the raw estimate
        return smoothed, fitness, {
            "velocity": np.asarray(states.v[n]),
            "bg": np.asarray(states.bg[n]),
            "ba": np.asarray(states.ba[n]),
            "smooth_gap": gap,
        }

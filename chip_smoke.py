#!/usr/bin/env python
"""Smoke test of the SLAM back end on the GPU, through its normal entry points.

    python chip_smoke.py               # one card: device, nn, pipeline,
                                       # fleet, retrieval, iris
    python chip_smoke.py --devices 4   # four cards: the sharded paths only

Each phase prints what it compared, against what, with which tolerance,
and its wall time. Any failed check stops the script with a non-zero exit.
Without a GPU, or outside a checkout of this repository, it exits non-zero
before any phase. The last line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases (one card):

- device: backend, card name and power limit (nvidia-smi), JAX version,
  XLA_FLAGS and the compile-cache directory.
- nn: the batched 1-NN Pallas kernel (``ops/nn_kernel.py``) against a
  per-coordinate jnp reference, and its time beside the plain XLA path, at
  the three widths the verification path runs.
- pipeline: ``Mapper.replay`` of a three-lap urban session at the
  realistic density of ``scripts/bench_quality.py``, a drain after every
  chunk; loops must close and ATE must beat dead reckoning by the
  golden's ratio bound.
- fleet: ``FleetMapper`` with two robots at ``bench.py``'s fleet widths,
  robot 1 driving robot 0's circuit one lane over.
- retrieval: ``bench.py``'s Scan Context workload, 256 queries over a
  4,096-keyframe database.
- iris: batched LiDAR-Iris matching at ``configs/two_robot_iris.yaml``
  widths against a numpy.fft encoding and the same program on the host.

``--devices 4`` runs a four-robot session at
``configs/four_robot_cityscale.yaml`` widths over a 1-D mesh of the four
cards (sharded descriptor DB, mesh drain, ``sharded_topk``) and the same
session unsharded on one card, and compares the two.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"== {name}: ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return out
        return run
    return wrap


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


@phase("device")
def phase_device(jax, n_devices):
    check(jax.default_backend() == "gpu",
          f"JAX backend is {jax.default_backend()!r}, not a GPU")
    devs = jax.devices()
    check(len(devs) >= n_devices,
          f"{n_devices} GPU(s) needed, {len(devs)} visible")
    print(f"device_kind={devs[0].device_kind} count={len(devs)}")
    print(f"card: {card()}")
    print(f"jax {jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}  "
          f"compile cache={jax.config.jax_compilation_cache_dir}")


def _timeit(jax, fn, *args, reps=20):
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@phase("nn")
def phase_nn(jax, jnp, np):
    from scl_slam.ops import nn_kernel, registration as reg
    from scl_slam.ops.pointcloud import PAD_VALUE

    @jax.jit
    def reference(q, t):  # per-coordinate exact f32, q [B,Nq,3], t [B,P,Nt]
        d2 = sum(jnp.square(q[:, :, c, None] - t[:, c, None, :])
                 for c in range(3))
        best2 = -jax.lax.top_k(-d2, 2)[0]
        return jnp.min(d2, -1), jnp.argmin(d2, -1), best2

    @jax.jit
    def plain(q, t):
        return jax.vmap(
            lambda a, b: reg._nearest_neighbors_plain(a, b[:3].T))(q, t)

    kernel = jax.jit(nn_kernel.nn_batched)
    # the verification path's widths: full-resolution ICP (32 lanes x 1024
    # source x 8192 submap), its coarse stage (icp_coarse_factor=4), and
    # the fleet's 16-lane batch
    widths = {"icp": (32, 1024, 8192), "icp_coarse": (32, 256, 2048),
              "fleet": (16, 1024, 8192)}
    rng = np.random.default_rng(0)
    for name, (B, nq, nt) in widths.items():
        # map-frame clouds 200 m out, 5% of targets at PAD_VALUE
        base = np.array([200.0, -150.0, 3.0], np.float32)
        t = base + rng.uniform(-30, 30, (B, nt, 3)).astype(np.float32)
        valid = rng.uniform(size=(B, nt)) > 0.05
        t = np.where(valid[..., None], t, PAD_VALUE).astype(np.float32)
        q = jnp.asarray(base + rng.uniform(-30, 30, (B, nq, 3)), jnp.float32)
        rows = jnp.asarray(np.swapaxes(t, 1, 2))
        lanes = jnp.ones((B,), bool)
        d, i = (np.asarray(x) for x in kernel(q, rows, lanes))
        rd, ri, r2 = (np.asarray(x) for x in reference(q, rows))
        tol = 1e-5 * np.maximum(1.0, rd)
        check(d.shape == (B, nq) and i.shape == (B, nq), f"{name}: shapes")
        check(bool(np.all(np.abs(d - rd) <= tol)),
              f"{name}: d2 off by {np.max(np.abs(d - rd) / np.maximum(1, rd))}")
        decided = (r2[..., 1] - r2[..., 0]) > tol
        check(bool(np.all(i[decided] == ri[decided])), f"{name}: argmin")
        t_k = _timeit(jax, kernel, q, rows, lanes)
        t_p = _timeit(jax, plain, q, rows)
        print(f"nn {name} {B}x{nq}x{nt}: |d2-ref| <= 1e-5*max(1,d2) f32, "
              f"idx equal on {decided.mean():.4f} of rows with a unique "
              f"minimum; kernel {t_k * 1e3:.3f} ms, plain XLA "
              f"{t_p * 1e3:.3f} ms (median of 20)")
    # lanes that are off run nothing and report inf
    lanes = jnp.asarray([True, False] * 8)
    d, _ = kernel(q, rows, lanes)
    check(bool(np.all(np.isinf(np.asarray(d)[1::2]))), "inactive lanes")


def _urban(n_azimuth=1024):
    from scl_slam.io.lidar_sim import LidarSim, UrbanScene

    scene = UrbanScene(seed=7, blocks=1, block_size=40.0)
    return scene, LidarSim(scene, n_azimuth=n_azimuth)


@phase("pipeline")
def phase_pipeline(jax, jnp, np):
    import bench_quality as bq
    from scl_slam.runtime import Mapper

    scene, sim = _urban()
    # three lane-offset laps (~624 keyframes): two laps close too few
    # loops for the anchor's ratio bound (0.901 measured on an H100)
    gt = bq.build_gt(scene, [0.0, 2.0, 1.0])
    odom = bq.drift_odometry(gt)
    m = Mapper(bq.anchor_config(1024))
    loops = bq.run_session(m, sim, gt, odom, 32, 6, tag="[pipeline]")
    traj = m.trajectory()
    ate_opt, ate_dead = bq.session_ate(m, gt, odom)
    ratio = ate_opt / ate_dead
    with open(os.path.join(REPO, "tests", "golden", "quality_ate.json")) as f:
        bound = json.load(f)["ratio_bound"]
    print(f"pipeline: {m._keyframes} keyframes, {loops} loop closures, "
          f"ATE {ate_opt:.3f} m vs dead reckoning {ate_dead:.3f} m, "
          f"ratio {ratio:.3f} (bound {bound}, f32)")
    check(loops >= 1, "no loop closed")
    check(bool(np.all(np.isfinite(traj))), "non-finite poses")
    check(ratio <= bound, f"ATE ratio {ratio:.3f} > {bound}")


def _circuit_frames(jnp, scene, sim, lanes, per_robot):
    """Interleaved (robot, pose, scan, stamp) frames: robot r drives the
    circuit on lane ``lanes[r]`` with ground-truth poses."""
    from scl_slam.geometry import se3

    tracks = [scene.circuit(lane_offset=o, step=1.0)[:per_robot]
              for o in lanes]
    frames = []
    for k in range(per_robot):
        for r, track in enumerate(tracks):
            T = track[k]
            pose = se3.Pose(jnp.asarray(T[:3, :3], jnp.float32),
                            jnp.asarray(T[:3, 3], jnp.float32))
            frames.append((r, pose, sim.scan_at(T, seed=1000 * r + k),
                           float(k)))
    return frames


@phase("fleet")
def phase_fleet(jax, jnp, np):
    from scl_slam.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams,
        SlamConfig,
    )
    from scl_slam.io.lidar_sim import SENSOR_HEIGHT
    from scl_slam.runtime import FleetMapper

    # bench.py's fleet widths: 65,536-point scans (64 beams x 1024
    # azimuths), 2,048-keyframe capacity, 8,192-point submaps
    cfg = SlamConfig(
        number_of_robots=2,
        keyframe=KeyframeConfig(max_keyframes=2048, points_per_keyframe=4096,
                                raw_points_capacity=65536),
        # +-6 keyframes per submap: the realistic-density submaps of
        # scripts/bench_quality.py, dense enough for RANSAC's 0.25 m
        # inlier threshold
        loop=LoopConfig(near_keyframes=6, submap_capacity=8192,
                        icp_iterations=20),
        optimizer=OptimizerConfig(edge_capacity=2048, gn_iters=4,
                                  cg_iters=32),
        scan_context=ScanContextParams(lidar_height=SENSOR_HEIGHT),
    )
    scene, sim = _urban()
    frames = _circuit_frames(jnp, scene, sim, [0.0, 1.0], 96)
    fm = FleetMapper(cfg)
    out = fm.replay(frames, apply_gate=False, batch=16, chunk_batches=2)
    chis = np.asarray(fm.optimize())
    inter = sum("inter_loop" in e for e in out["events"])
    intra = sum("loop" in e for e in out["events"])
    traj = [fm.trajectory(robot=r) for r in range(2)]
    print(f"fleet: keyframes {out['keyframes']}, {intra} intra and {inter} "
          f"inter loop closures, final chi2 {chis.ravel()[-1]:.4g}")
    check(inter > 0, "no inter-robot loop accepted")
    check(bool(np.all(np.isfinite(chis))), "non-finite joint solve")
    check(all(bool(np.all(np.isfinite(t))) for t in traj),
          "non-finite poses")


@phase("retrieval")
def phase_retrieval(jax, jnp, np):
    import bench

    rec = bench.bench_retrieval(jax, jnp)   # asserts 256 of 256 correct
    print(f"retrieval: 256/256 queries matched their keyframe over a "
          f"4096-keyframe DB; {rec['value']} queries/s")


@phase("iris")
def phase_iris(jax, jnp, np):
    from scl_slam.descriptors import lidar_iris as li
    from scl_slam.ops.pointcloud import from_points

    cfg = li.LidarIrisConfig(rows=80, cols=360, n_scan=64,
                             distance_threshold=0.32, exclude_recent=30,
                             num_candidates=10, match_mode=2)
    scene, sim = _urban()
    track = scene.circuit(lane_offset=0.0, step=1.0)
    K, B, n_real = 2048, 16, 48
    iris = [li.make(from_points(sim.scan_at(track[4 * k], seed=k), 65536),
                    cfg) for k in range(n_real)]
    real = np.stack([np.asarray(d.image) for d in iris])
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (K, cfg.rows, cfg.cols)).astype(np.float32)
    keys = rng.uniform(0, 3, (K, cfg.rows)).astype(np.float32)
    slots = rng.choice(K - 64, n_real, replace=False)
    imgs[slots] = real
    keys[slots] = np.stack([np.asarray(d.row_key) for d in iris])
    db = li.make_db(K, cfg)._replace(
        descriptors=jnp.asarray(imgs), keys=jnp.asarray(keys),
        robot=jnp.zeros((K,), jnp.int32),
        index=jnp.arange(K, dtype=jnp.int32),
        count=jnp.array(K, jnp.int32))
    pick = rng.choice(n_real, B, replace=False)
    # queries: the stored scans seen with a yaw offset of 37 columns
    q_img = np.roll(real[pick], 37, axis=2)
    q_key = keys[slots[pick]]
    args = (jnp.asarray(q_img), jnp.asarray(q_key),
            jnp.zeros((B,), jnp.int32), jnp.full((B,), K - 1, jnp.int32))
    t0 = time.perf_counter()
    m = li.query_batch(db, *args, cfg)
    jax.block_until_ready(m)
    t_first = time.perf_counter() - t0
    t_run = _timeit(jax, lambda: li.query_batch(db, *args, cfg), reps=10)
    check(bool(np.all(np.asarray(m.index) == slots[pick])),
          "iris retrieval missed a stored scan")

    # the same program on the host's CPU device
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        db_h = jax.device_put(db, cpu)
        m_h = li.query_batch(db_h, *jax.device_put(args, cpu), cfg)
    dd = np.abs(np.asarray(m.distance) - np.asarray(m_h.distance))
    dy = np.abs(np.asarray(m.yaw) - np.asarray(m_h.yaw))
    check(float(dd.max()) < 5e-3, f"iris distance vs host {dd.max()}")
    check(float(dy.max()) < 1e-5, f"iris yaw vs host {dy.max()}")

    # quadrature encoding against numpy.fft
    bank = np.asarray(li.log_gabor_bank(cfg))
    T, M = jax.jit(jax.vmap(lambda im: li.encode_features(im, cfg)))(
        jnp.asarray(q_img))
    spec = np.fft.fft(q_img.astype(np.float64), axis=-1)
    resp = np.fft.ifft(spec[:, None] * bank[None, :, None, :], axis=-1)
    T_np = np.stack([resp.real > 0, resp.imag > 0], axis=-1)
    M_np = np.abs(resp) < (li._M_THRESH_REF / cfg.cols)
    # f32 transforms of 0..255 images carry ~1e-5 of rounding: a bit or
    # mask whose value lies that close to its threshold may flip between
    # f32 and f64, so compare the ones clear of it by 1e-4
    thr = li._M_THRESH_REF / cfg.cols
    clear = np.stack([np.abs(resp.real), np.abs(resp.imag)], -1) > 1e-4
    m_clear = np.abs(np.abs(resp) - thr) > 1e-4
    bits = float((np.asarray(T) == T_np)[clear].mean())
    masks = float((np.asarray(M) == M_np)[m_clear].mean())
    compared = float(m_clear.mean())
    check(bits > 0.999 and masks > 0.999, f"iris bits {bits} masks {masks}")
    print(f"iris: {B} queries x {cfg.num_candidates} candidates over {K} "
          f"keyframes, all found; distance |gpu-host| {dd.max():.2e} "
          f"(< 5e-3), yaw {dy.max():.2e} (< 1e-5); quadrature bits "
          f"{bits:.5f}, masks {masks:.5f} equal to numpy.fft f64 (> 0.999, "
          f"{compared:.4f} of cells clear of rounding); "
          f"{t_run * 1e3:.2f} ms per batch, first call {t_first:.1f} s")


@phase("multi-card")
def phase_mesh(jax, jnp, np):
    from jax.sharding import Mesh

    from scl_slam.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams,
        SlamConfig,
    )
    from scl_slam.io.lidar_sim import SENSOR_HEIGHT
    from scl_slam.parallel.sharded import sharded_topk
    from scl_slam.runtime import FleetMapper

    # configs/four_robot_cityscale.yaml widths, 64 keyframes per robot
    cfg = SlamConfig(
        number_of_robots=4,
        keyframe=KeyframeConfig(max_keyframes=4096, points_per_keyframe=4096,
                                raw_points_capacity=131072,
                                distance_threshold=1.0),
        loop=LoopConfig(history_fitness_score=0.3, near_keyframes=25,
                        submap_capacity=16384, ransac_inlier_ratio=0.45),
        optimizer=OptimizerConfig(gn_iters=8, cg_iters=96, coarse_stride=32,
                                  edge_capacity=32768, use_pcm=True,
                                  pcm_threshold=0.75),
        scan_context=ScanContextParams(num_rings=20, num_sectors=60,
                                       exclude_recent=100,
                                       distance_threshold=0.14,
                                       lidar_height=SENSOR_HEIGHT),
    )
    mesh = Mesh(np.array(jax.devices()[:4]), ("shard",))
    scene, sim = _urban(n_azimuth=2048)
    frames = _circuit_frames(jnp, scene, sim, [0.0, 2.0, 1.0, 3.0], 64)

    def session(sharded: bool):
        fm = FleetMapper(cfg)
        if sharded:
            fm.shard_database(mesh)
            fm.attach_mesh(mesh)
        else:
            # same drain (two-stage distributed solve) on a one-card mesh:
            # the default single-device drain is another solver, which
            # converges to within ~5 cm of it, not to rounding
            fm.attach_mesh(Mesh(np.array(jax.devices()[:1]), ("shard",)))
        t0 = time.perf_counter()
        out = fm.replay(frames, apply_gate=False, batch=16, chunk_batches=2)
        chis = np.asarray(fm.optimize())
        traj = np.stack([fm.trajectory(robot=r) for r in range(4)])
        loops = (sum("loop" in e for e in out["events"]),
                 sum("inter_loop" in e for e in out["events"]))
        return fm, out["keyframes"], loops, traj, chis, (
            time.perf_counter() - t0)

    fm_s, kf_s, loops_s, traj_s, chis_s, t_s = session(True)
    _, kf_1, loops_1, traj_1, chis_1, t_1 = session(False)
    dev = float(np.max(np.abs(traj_s[..., :3, 3] - traj_1[..., :3, 3])))
    print(f"mesh: 4 cards, keyframes {kf_s} vs one card {kf_1}; intra/inter "
          f"loops {loops_s} vs {loops_1}; max position difference "
          f"{dev:.2e} m (tolerance 1e-2 m: sharded sums reorder f32 adds); "
          f"sharded {t_s:.1f} s, one card {t_1:.1f} s (both include compile)")
    check(kf_s == kf_1, "keyframe counts differ")
    check(loops_s == loops_1, "loop counts differ")
    check(bool(np.all(np.isfinite(chis_s)) and np.all(np.isfinite(chis_1))),
          "non-finite solve")
    check(dev <= 1e-2, f"trajectories differ by {dev} m")

    db = fm_s.state.desc_db
    mask = np.arange(db.keys.shape[0]) % 7 != 0
    d_s, p_s = sharded_topk(mesh, "shard", db.keys, db.keys[5],
                            jax.device_put(jnp.asarray(mask),
                                           db.keys.sharding), 10)
    keys = np.asarray(db.keys)
    d2 = np.where(mask, ((keys - keys[5]) ** 2).sum(-1), np.inf)
    ref = np.sort(d2)[:10]
    check(bool(np.allclose(np.asarray(d_s), ref, rtol=1e-5, atol=1e-6)),
          "sharded_topk distances")
    print(f"sharded_topk over {keys.shape[0]} rows on 4 cards equals the "
          f"host top-10 (rtol 1e-5)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4 runs only the sharded paths, over four cards")
    args = ap.parse_args()

    sys.path[:0] = [REPO, os.path.join(REPO, "scripts")]
    try:
        import scl_slam  # noqa: F401
    except ImportError as e:
        fail(f"run from a checkout of the repository ({e})")
    import jax
    import jax.numpy as jnp
    import numpy as np

    phase_device(jax, args.devices)
    if args.devices == 4:
        phase_mesh(jax, jnp, np)
    else:
        phase_nn(jax, jnp, np)
        phase_pipeline(jax, jnp, np)
        phase_fleet(jax, jnp, np)
        phase_retrieval(jax, jnp, np)
        phase_iris(jax, jnp, np)
    dev = jax.devices()[0]
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched 1-NN: the GPU kernel (ops/nn_kernel.py, run here in Pallas's
interpret mode), the plain XLA path, and the wrapper that picks between
them (ops/registration.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scl_slam.geometry import se3, so3
from scl_slam.ops import nn_kernel
from scl_slam.ops import pointcloud as pc
from scl_slam.ops import registration as reg

kernel = functools.partial(nn_kernel.nn_batched, interpret=True)


def ref_nn(q, t):
    """Per-coordinate numpy reference: q [B, Nq, 3], t [B, Nt, 3]."""
    d2 = sum(
        (q[:, :, None, c].astype(np.float64) - t[:, None, :, c]) ** 2
        for c in range(3)
    )
    return d2.min(-1), d2.argmin(-1)


def clouds(B, nq, nt, seed=0, scale=20.0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-scale, scale, (B, nq, 3)).astype(np.float32)
    t = rng.uniform(-scale, scale, (B, nt, 3)).astype(np.float32)
    return q, t


def run_kernel(q, t, lanes=None, **kw):
    B = q.shape[0]
    lanes = np.ones(B, bool) if lanes is None else lanes
    d, i = kernel(
        jnp.asarray(q), jnp.asarray(np.swapaxes(t, 1, 2)),
        jnp.asarray(lanes), **kw
    )
    return np.asarray(d), np.asarray(i)


def assert_matches(d, i, q, t):
    rd, ri = ref_nn(q, t)
    np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i, ri)


@pytest.fixture
def on_gpu(monkeypatch):
    """Route the registration wrapper to the kernel (interpret mode)."""
    monkeypatch.setattr(reg.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(reg.nn_kernel, "nn_batched", kernel)


class TestKernel:
    def test_solo(self):
        q, t = clouds(1, 200, 700)
        assert_matches(*run_kernel(q, t), q, t)

    def test_inactive_lanes(self):
        q, t = clouds(3, 100, 300, seed=1)
        d, i = run_kernel(q, t, lanes=np.array([True, False, True]))
        assert np.all(np.isinf(d[1])) and np.all(i[1] == 0)
        assert_matches(d[[0, 2]], i[[0, 2]], q[[0, 2]], t[[0, 2]])

    def test_many_target_tiles(self):
        q, t = clouds(2, 64, 1000, seed=2)
        d, i = run_kernel(q, t, bq=16, bt=32)   # 32 target tiles
        assert_matches(d, i, q, t)

    @pytest.mark.parametrize(
        "nq,nt", [(1, 1), (17, 300), (100, 65), (130, 1000)]
    )
    def test_ragged_shapes(self, nq, nt):
        q, t = clouds(2, nq, nt, seed=nq)
        d, i = run_kernel(q, t)
        assert d.shape == i.shape == (2, nq)
        assert_matches(d, i, q, t)

    @pytest.mark.parametrize("bq,bt", [(16, 256), (32, 128), (64, 64)])
    def test_block_sizes(self, bq, bt):
        q, t = clouds(2, 150, 500, seed=bq)
        assert_matches(*run_kernel(q, t, bq=bq, bt=bt), q, t)

    def test_pad_targets_never_win(self):
        q, t = clouds(1, 80, 200, seed=3)
        t[0, ::3] = pc.PAD_VALUE
        d, i = run_kernel(q, t)
        assert np.all(i % 3 != 0)
        assert_matches(d, i, q, t)

    def test_lowest_index_wins_ties(self):
        # every target point appears twice, in different tiles and slots
        q, t = clouds(1, 50, 100, seed=4)
        t2 = np.concatenate([t, t, t[:, ::-1]], axis=1)       # [1, 300, 3]
        d, i = run_kernel(q, t2, bq=16, bt=32)
        _, ri = ref_nn(q, t)
        np.testing.assert_array_equal(i, ri)    # first copy, not a later one

    def test_exact_hit_is_zero(self):
        q, t = clouds(1, 40, 300, seed=5)
        q[0, :20] = t[0, 100:120]
        d, i = run_kernel(q, t)
        assert np.all(d[0, :20] == 0.0)
        np.testing.assert_array_equal(i[0, :20], np.arange(100, 120))

    @pytest.mark.parametrize(
        "B,nq,want", [(32, 1024, 64), (16, 1024, 64), (32, 256, 32),
                      (16, 256, 16), (1, 100, 16)]
    )
    def test_block_q_fills_the_grid(self, B, nq, want):
        assert nn_kernel.block_q(B, nq) == want


class TestPlainPath:
    def test_matches_numpy_reference(self):
        q, t = clouds(1, 300, 900, seed=6)
        d, i = reg._nearest_neighbors_plain(jnp.asarray(q[0]), jnp.asarray(t[0]))
        rd, ri = ref_nn(q, t)
        # expanded |q|^2 - 2qt + |t|^2 form: f32 cancellation error grows
        # with |coordinates|^2, so the distance tolerance is absolute
        np.testing.assert_allclose(np.asarray(d), rd[0], atol=2e-3)
        gap = np.sort(
            sum((q[0, :, None, c] - t[0, None, :, c]) ** 2 for c in range(3)),
            -1,
        )
        decided = gap[:, 1] - gap[:, 0] > 1e-2
        np.testing.assert_array_equal(np.asarray(i)[decided], ri[0][decided])

    def test_batched_masks_inactive_lanes(self):
        q, t = clouds(3, 60, 200, seed=7)
        lanes = jnp.asarray([True, False, True])
        d, i = reg.nearest_neighbors_batched(
            jnp.asarray(q), jnp.asarray(np.swapaxes(t, 1, 2)), lanes
        )
        d, i = np.asarray(d), np.asarray(i)
        assert np.all(np.isinf(d[1])) and np.all(i[1] == 0)
        rd, ri = ref_nn(q, t)
        np.testing.assert_array_equal(i[[0, 2]], ri[[0, 2]])


class TestDispatch:
    @pytest.mark.parametrize("backend,uses_kernel", [("cpu", False),
                                                     ("gpu", True)])
    def test_backend_picks_path(self, monkeypatch, backend, uses_kernel):
        calls = []

        def spy(*a, **kw):
            calls.append(1)
            return kernel(*a, **kw)

        monkeypatch.setattr(reg.jax, "default_backend", lambda: backend)
        monkeypatch.setattr(reg.nn_kernel, "nn_batched", spy)
        q, t = clouds(2, 30, 90, seed=8)
        reg.nearest_neighbors_batched(
            jnp.asarray(q), jnp.asarray(np.swapaxes(t, 1, 2)),
            jnp.ones(2, bool),
        )
        reg.nearest_neighbors(jnp.asarray(q[0]), jnp.asarray(t[0]))
        assert len(calls) == (2 if uses_kernel else 0)

    @pytest.mark.parametrize("rows", [4, 7])
    def test_payload_rows_through_wrapper(self, on_gpu, rows):
        q, t = clouds(1, 90, 250, seed=rows)
        extra = np.random.default_rng(rows).normal(size=(rows - 3, 250))
        payload = jnp.asarray(
            np.concatenate([t[0].T, extra]).astype(np.float32)
        )
        d, sel = reg.nearest_select(jnp.asarray(q[0]), payload)
        rd, ri = ref_nn(q, t)
        assert sel.shape == (rows, 90)
        np.testing.assert_allclose(np.asarray(d), rd[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            np.asarray(sel), np.asarray(payload)[:, ri[0]]
        )

    def test_solo_wrapper_under_vmap(self, on_gpu):
        q, t = clouds(3, 40, 120, seed=9)
        d, i = jax.vmap(reg.nearest_neighbors)(jnp.asarray(q), jnp.asarray(t))
        assert_matches(np.asarray(d), np.asarray(i), q, t)


def _icp_problem(B=3, n=256, m=512):
    key = jax.random.PRNGKey(11)
    tgt = jax.random.uniform(key, (B, m, 3), minval=-8.0, maxval=8.0)
    gt = se3.Pose(
        so3.exp(jnp.array([0.01, -0.02, 0.08])), jnp.array([0.3, -0.2, 0.1])
    )
    src = se3.transform_points(se3.inverse(gt), tgt[:, :n])
    return (
        pc.Cloud(src, jnp.ones((B, n), bool)),
        pc.Cloud(tgt, jnp.ones((B, m), bool)),
    )


class TestVerificationThroughKernel:
    """ICP and RANSAC give the plain path's answers when the NN pass runs
    in the kernel."""

    def test_icp_batched(self, monkeypatch):
        src, tgt = _icp_problem()
        args = (src, tgt, se3.identity((3,)), jnp.array([True, False, True]))
        kw = dict(max_iters=15, max_corr_dist=2.0, tol=1e-5, coarse_factor=4)
        ref = reg.icp_batched(*args, **kw)
        monkeypatch.setattr(reg.jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(reg.nn_kernel, "nn_batched", kernel)
        got = reg.icp_batched(*args, **kw)
        np.testing.assert_allclose(
            np.asarray(got.pose.t), np.asarray(ref.pose.t), atol=1e-4
        )
        # the plain path's expanded-form distances floor near 1e-6 m^2 at
        # these coordinates; the kernel's per-coordinate ones reach ~1e-11
        np.testing.assert_allclose(
            np.asarray(got.fitness)[[0, 2]], np.asarray(ref.fitness)[[0, 2]],
            atol=1e-5,
        )
        assert np.isinf(np.asarray(got.fitness)[1])

    def test_ransac_batched(self, monkeypatch):
        src, tgt = _icp_problem()
        args = (src, tgt, jax.random.PRNGKey(2), jnp.array([True, True, False]))
        ref = reg.ransac_align_batched(*args, num_hypotheses=64,
                                       inlier_thresh=0.3)
        monkeypatch.setattr(reg.jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(reg.nn_kernel, "nn_batched", kernel)
        got = reg.ransac_align_batched(*args, num_hypotheses=64,
                                       inlier_thresh=0.3)
        np.testing.assert_array_equal(
            np.asarray(got.success), np.asarray(ref.success)
        )
        np.testing.assert_allclose(
            np.asarray(got.inlier_ratio), np.asarray(ref.inlier_ratio),
            atol=1e-2,
        )

    def test_point_to_plane(self, monkeypatch):
        src, tgt = _icp_problem(B=1)
        src = pc.Cloud(src.xyz[0], src.mask[0])
        tgt = pc.Cloud(tgt.xyz[0], tgt.mask[0])
        normals = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (512, 1))
        ref = reg.icp_point_to_plane(src, tgt, normals, max_iters=3)
        monkeypatch.setattr(reg.jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(reg.nn_kernel, "nn_batched", kernel)
        got = reg.icp_point_to_plane(src, tgt, normals, max_iters=3)
        np.testing.assert_allclose(
            np.asarray(got.pose.t), np.asarray(ref.pose.t), atol=1e-4
        )


@pytest.mark.gpu
def test_compiled_kernel_on_gpu():
    """The kernel as compiled for the card (not interpreted) at the ICP
    width; chip_smoke.py's nn phase checks the same at all three widths."""
    q, t = clouds(32, 1024, 8192, seed=12)
    d, i = nn_kernel.nn_batched(
        jnp.asarray(q), jnp.asarray(np.swapaxes(t, 1, 2)), jnp.ones(32, bool)
    )
    rd, _ = ref_nn(q[:2], t[:2])
    np.testing.assert_allclose(np.asarray(d)[:2], rd, rtol=1e-5, atol=1e-5)

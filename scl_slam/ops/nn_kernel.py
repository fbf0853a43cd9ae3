"""Batched 1-NN for the GPU: one Pallas kernel on the Triton route.

This is the pass every ICP iteration and every RANSAC correspondence search
spends its time in: for each query point of each lane, the squared distance
to its nearest target point and that point's index. The plain XLA form
(:func:`scl_slam.ops.registration.nearest_neighbors`) writes a
[256, Nt] distance block to device memory per query block and reads it
back for the argmin. Here each program owns ``bq`` query points of one
lane and walks that lane's target in ``bt``-point tiles, keeping a
[bq, bt] running (min, tile) pair in registers; only the (d2, idx) result
leaves the SM.

- Distances are per coordinate, ``(q - t)^2`` summed, in FP32 on the CUDA
  cores. With K=3 the tensor cores have nothing to offer, and TF32 would
  break the exact-f32 distances the accept gate relies on.
- The running pair is updated elementwise on strict ``<``, so within each
  column slot the earliest tile wins a tie; the final row reduction picks
  the lowest global index among the minima. That is ``jnp.argmin``'s rule.
- Ragged ``Nq``/``Nt`` are handled by masked loads (missing targets read
  as +inf), so every shape takes this path.
- A lane whose flag is 0 runs no target tile and returns d2=+inf, idx=0.

Payload rows (validity, normals) are gathered outside with
``take_along_axis``; XLA fuses that gather into its consumers.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

TILE = 4096         # elements of the [bq, bt] running-min tile
MAX_BQ = 64         # query points per program, at most
MIN_PROGRAMS = 256  # ~2 programs per SM of an H100 (132 SMs)
NUM_WARPS = 4
NUM_STAGES = 2
_NO_INDEX = jnp.iinfo(jnp.int32).max


def block_q(B: int, nq: int) -> int:
    """Query points per program: ``MAX_BQ``, halved (down to 16) while the
    grid would hold fewer than ``MIN_PROGRAMS`` programs, so that narrow
    passes (the coarse ICP stage, small batches) still fill the card."""
    bq = MAX_BQ
    while bq > 16 and B * pl.cdiv(nq, bq) < MIN_PROGRAMS:
        bq //= 2
    return bq


def _nn_kernel(lane_ref, q_ref, t_ref, d_ref, i_ref, *, nq, nt, bq, bt):
    """Grid (B, cdiv(Nq, bq)). lane_ref [B] i32; q_ref [B, 3, Nq];
    t_ref [B, P, Nt] (rows 0-2 read); d_ref / i_ref [B, Nq]."""
    b = pl.program_id(0)
    q0 = pl.program_id(1) * bq
    qmask = q0 + jnp.arange(bq) < nq
    q = [
        plgpu.load(q_ref.at[b, c, pl.ds(q0, bq)], mask=qmask, other=0.0)
        for c in range(3)
    ]
    # lane flags are 0/1, so an inactive lane runs zero target tiles
    trips = lane_ref[b] * jnp.int32(pl.cdiv(nt, bt))

    def body(j, carry):
        best, tile = carry
        tmask = j * bt + jnp.arange(bt) < nt
        d2 = jnp.zeros((bq, bt), jnp.float32)
        for c in range(3):
            t = plgpu.load(
                t_ref.at[b, c, pl.ds(j * bt, bt)], mask=tmask, other=jnp.inf
            )
            diff = q[c][:, None] - t[None, :]
            d2 = d2 + diff * diff
        take = d2 < best
        return jnp.where(take, d2, best), jnp.where(take, j, tile)

    best, tile = jax.lax.fori_loop(
        0,
        trips,
        body,
        (
            jnp.full((bq, bt), jnp.inf, jnp.float32),
            jnp.zeros((bq, bt), jnp.int32),
        ),
    )
    d_min = jnp.min(best, axis=1)
    gidx = tile * bt + jnp.arange(bt)[None, :]
    idx = jnp.min(jnp.where(best == d_min[:, None], gidx, _NO_INDEX), axis=1)
    idx = jnp.where(d_min < jnp.inf, idx, 0)
    plgpu.store(d_ref.at[b, pl.ds(q0, bq)], d_min, mask=qmask)
    plgpu.store(i_ref.at[b, pl.ds(q0, bq)], idx, mask=qmask)


@functools.partial(jax.jit, static_argnames=("bq", "bt", "interpret"))
def nn_batched(
    query: jax.Array,
    target_rows: jax.Array,
    lanes: jax.Array,
    *,
    bq: int | None = None,
    bt: int | None = None,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """1-NN of each lane's queries in that lane's target.

    query [B, Nq, 3]; target_rows [B, P, Nt] with P >= 3, coordinate-major:
    rows 0-2 are the target xyz and further rows (an ICP payload's validity
    and normals) are not read; lanes [B] bool. Returns
    (sq_dist [B, Nq] f32, index [B, Nq] i32); lanes that are off get
    sq_dist=+inf and index=0. ``bq`` and ``bt`` (powers of two) default to
    :func:`block_q` and ``TILE // bq``.
    """
    B, nq, _ = query.shape
    nt = target_rows.shape[2]
    bq = bq or block_q(B, nq)
    bt = bt or TILE // bq
    kernel = functools.partial(_nn_kernel, nq=nq, nt=nt, bq=bq, bt=bt)
    return pl.pallas_call(
        kernel,
        grid=(B, pl.cdiv(nq, bq)),
        out_shape=[
            jax.ShapeDtypeStruct((B, nq), jnp.float32),
            jax.ShapeDtypeStruct((B, nq), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="nn_batched",
    )(
        lanes.astype(jnp.int32),
        jnp.swapaxes(query, 1, 2).astype(jnp.float32),
        target_rows.astype(jnp.float32),
    )

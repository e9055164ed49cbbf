"""Fused exact kNN selection for the GPU: a Pallas kernel on the Triton route.

One program owns ``block_q`` query rows of one batch member and walks the
reference set in ``block_r``-row tiles inside the program.  Each tile's
squared distances come from the identity ||q-r||^2 = ||q||^2 + ||r||^2 - 2 q.r
with the product in IEEE f32 (never TF32: the candidate-sufficiency guard's
2^-10 margin in ops/knn.py assumes f32 ranking noise).  The running top-k
stays in registers as (value, index) pairs; a tile is merged only while some
row of the block holds a distance below that row's current k-th best, so
once the candidate sets settle most tiles cost one min-reduction.  Only the
(rows, k) result is written to device memory — the XLA path
(``knn_select_xla``) instead writes and re-reads a (rows, block) distance
tile every step.

Coordinates are zero-padded to a multiple of 16 (the smallest width the
Triton dot takes); the true reference count ``nr`` is a runtime operand, so
one compile serves every chain in a row bucket.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .knn import KERNEL_MAX_K

# 64 x 64 tiles measured fastest on an H100 (PERF.md); 128 x 128 spills
BLOCK_Q = 64
BLOCK_R = 64
_DPAD = 16


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _knn_kernel(nr_ref, q_ref, r_ref, d2_ref, idx_ref, *, k: int,
                block_r: int, self_mode: bool):
    block_q, kpad = d2_ref.shape
    nr = nr_ref[...]
    q = q_ref[...]
    q_sq = jnp.sum(q * q, axis=1)
    qrow = pl.program_id(1) * block_q + lax.broadcasted_iota(
        jnp.int32, (block_q, block_r), 0)
    slot = lax.broadcasted_iota(jnp.int32, (block_q, kpad), 1)
    lane = lax.broadcasted_iota(jnp.int32, (block_q, block_r), 1)
    # slots beyond k hold -inf: never the worst, never replaced
    best_d = jnp.where(slot < k, jnp.inf, -jnp.inf).astype(jnp.float32)
    best_i = jnp.full((block_q, kpad), -1, jnp.int32)

    def tile(j, carry):
        best_d, best_i = carry
        r = r_ref[pl.ds(j * block_r, block_r), :]
        r_sq = jnp.sum(r * r, axis=1)
        d2 = (q_sq[:, None] + r_sq[None, :]
              - 2.0 * jnp.dot(q, r.T, precision=lax.Precision.HIGHEST))
        col = j * block_r + lane
        d2 = jnp.where(col < nr, d2, jnp.inf)
        if self_mode:
            # pin the self pair below any genuine distance (slot 0 after
            # the final sort; clamped back to 0 by the wrapper)
            d2 = jnp.where(col == qrow, -1.0, d2)

        def pending(c):
            d2, best_d, _ = c
            better = jnp.min(d2, axis=1) < jnp.max(best_d, axis=1)
            return jnp.max(better.astype(jnp.int32)) > 0

        def insert(c):
            # move each row's nearest remaining tile entry into its worst
            # slot when it beats it
            d2, best_d, best_i = c
            m = jnp.min(d2, axis=1)
            at = jnp.argmin(d2, axis=1).astype(jnp.int32)
            take = m < jnp.max(best_d, axis=1)
            worst = jnp.argmax(best_d, axis=1).astype(jnp.int32)
            put = (slot == worst[:, None]) & take[:, None]
            best_d = jnp.where(put, m[:, None], best_d)
            best_i = jnp.where(put, j * block_r + at[:, None], best_i)
            d2 = jnp.where((lane == at[:, None]) & take[:, None], jnp.inf, d2)
            return d2, best_d, best_i

        _, best_d, best_i = lax.while_loop(pending, insert,
                                           (d2, best_d, best_i))
        return best_d, best_i

    best_d, best_i = lax.fori_loop(0, (nr + block_r - 1) // block_r, tile,
                                   (best_d, best_i))
    d2_ref[...] = best_d
    idx_ref[...] = best_i


@functools.partial(jax.jit, static_argnames=("k", "self_mode", "block_q",
                                             "block_r", "interpret"))
def knn_select_triton_batched(query, ref, k: int, self_mode: bool = False,
                              nr=None, *, block_q: int = BLOCK_Q,
                              block_r: int = BLOCK_R,
                              interpret: bool = False):
    """Batched exact kNN selection, same contract as a vmapped
    ``knn_select_xla``: ``query`` (B, Nq, d), ``ref`` (B, Nr, d), ``nr`` (B,)
    true reference counts (rows beyond are padding, whatever they hold).
    Returns (d2, idx), each (B, Nq, k), ascending; absent slots are
    (+inf, -1).  ``k`` may not exceed ``KERNEL_MAX_K``."""
    b, nq, d = query.shape
    nr_pad = ref.shape[1]
    if nr is None:
        nr = jnp.full((b,), nr_pad, jnp.int32)
    nr = jnp.asarray(nr, jnp.int32).reshape(b)
    k = min(k, nr_pad)
    if k > KERNEL_MAX_K:
        raise ValueError(f"k={k} > KERNEL_MAX_K={KERNEL_MAX_K}")
    kpad = _next_pow2(k)

    # centre on the valid reference rows (translation-invariant; keeps the
    # f32 identity free of cancellation for offset chains) — padding rows
    # carry no contract beyond "never selected", so they must not shift mu
    ok = (jnp.arange(nr_pad)[None, :] < nr[:, None])[..., None]
    mu = jnp.sum(jnp.where(ok, ref, 0), axis=1, keepdims=True) / jnp.maximum(
        nr.astype(query.dtype), 1.0)[:, None, None]
    dp = -(-d // _DPAD) * _DPAD
    nq_p = -(-nq // block_q) * block_q
    nr_p = -(-nr_pad // block_r) * block_r
    q = jnp.pad(query - mu, ((0, 0), (0, nq_p - nq), (0, dp - d)))
    r = jnp.pad(ref - mu, ((0, 0), (0, nr_p - nr_pad), (0, dp - d)))

    kernel = functools.partial(_knn_kernel, k=k, block_r=block_r,
                               self_mode=self_mode)
    out_shape = (jax.ShapeDtypeStruct((b, nq_p, kpad), jnp.float32),
                 jax.ShapeDtypeStruct((b, nq_p, kpad), jnp.int32))
    out_spec = pl.BlockSpec((None, block_q, kpad), lambda i, j: (i, j, 0))
    d2, idx = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(b, nq_p // block_q),
        in_specs=[pl.BlockSpec((None,), lambda i, j: (i,)),
                  pl.BlockSpec((None, block_q, dp), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((None, nr_p, dp), lambda i, j: (i, 0, 0))],
        out_specs=(out_spec, out_spec),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="knn_select",
    )(nr, q.astype(jnp.float32), r.astype(jnp.float32))
    d2, idx = d2[:, :nq, :k], idx[:, :nq, :k]
    d2, idx = lax.sort((d2, idx), dimension=2, num_keys=1)
    return jnp.maximum(d2, 0.0), idx


def knn_select_triton(query, ref, k: int, self_mode: bool = False, nr=None,
                      **kw):
    """Single-cell form of :func:`knn_select_triton_batched`: ``query``
    (Nq, d), ``ref`` (Nr, d), scalar ``nr``."""
    nr = ref.shape[0] if nr is None else nr
    d2, idx = knn_select_triton_batched(
        query[None], ref[None], k, self_mode,
        jnp.asarray(nr, jnp.int32).reshape(1), **kw)
    return d2[0], idx[0]

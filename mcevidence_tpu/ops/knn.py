"""Exact k-nearest-neighbour distances on the accelerator.

Replaces the reference's sklearn ``NearestNeighbors(...).kneighbors`` core
(reference MCEvidence.py:1093-1104) with a device-native exact brute-force
search:

* selection: tiled pairwise squared-L2 via the identity
  ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b, with a running top-k merged across
  reference blocks (the O(N^2 d) work is one matrix product per block).
* refinement (parity path): the float32 selection keeps a few extra
  candidates; their distances are recomputed exactly in float64 with the
  cancellation-free difference form and re-sorted.  This gives sklearn/f64
  agreement to ~1e-12 while the O(N^2) sweep stays in fast f32.

Auto-evidence ("self mode") keeps the reference's semantics: the query point
itself appears as neighbour 0 with distance exactly 0 (sklearn returns the
self-match first; the estimator skips k=0; reference MCEvidence.py:1097-1104).

Shape discipline: chain lengths vary per model, so sample counts are padded
up to a coarse geometric grid of "buckets" ({1, 1.25, 1.5, 1.75} x 2^j x 512
rows) and the true row count is passed as a *runtime* scalar.  One compile
then serves every chain in the bucket; over-padding costs at most ~56% extra
pairwise work.

Two selection engines share one interface, picked by :func:`select_engine`:
* ``xla``    — ``knn_select_xla``: jax.numpy + lax.scan; the CPU engine and
  the test oracle.
* ``triton`` — ``ops/knn_triton.py``: a fused Pallas kernel on the Triton
  route, the GPU engine for up to ``KERNEL_MAX_K`` candidates.
"""

from __future__ import annotations

import functools
import logging
import math
import os
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)

BUCKET_QUANTUM = 512

ENGINES = ("auto", "xla", "triton")
# largest candidate count the GPU kernel keeps in registers; the guard's
# re-selection asks for more and takes knn_select_xla
KERNEL_MAX_K = 16


def select_engine(engine: str = "auto") -> str:
    """Validate a kNN engine name and resolve ``auto`` for the platform:
    the Triton kernel on ``gpu``, ``xla`` on ``cpu``.  Any other platform,
    or an unknown name, is an error — never a silent substitute."""
    if engine not in ENGINES:
        raise ValueError(f"unknown kNN engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if engine != "auto":
        return engine
    platform = jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no kNN engine for platform {platform!r} "
                       "(supported: gpu, cpu)")


def _kernel_takes(engine: str, k: int) -> bool:
    if engine != "triton":
        return False
    if k > KERNEL_MAX_K:
        # the guard's re-selection: lax.top_k runs on the device here too
        logger.info("kNN selection of %d candidates exceeds the kernel's "
                    "%d; using knn_select_xla", k, KERNEL_MAX_K)
        return False
    return True


def knn_select(query, ref, k: int, *, self_mode: bool = False, nr=None,
               engine: str = "xla"):
    """(d2, idx) selection of ``k`` neighbours with a resolved engine name
    (see :func:`select_engine`); same contract as ``knn_select_xla``."""
    if _kernel_takes(engine, k):
        from .knn_triton import knn_select_triton
        return knn_select_triton(query, ref, k, self_mode, nr)
    return knn_select_xla(query, ref, k, self_mode=self_mode, nr=nr)


def knn_select_batched(query, ref, k: int, *, self_mode: bool = False,
                       nr=None, engine: str = "xla"):
    """Batched :func:`knn_select`: (B, N, d) inputs, (B,) runtime counts."""
    if _kernel_takes(engine, k):
        from .knn_triton import knn_select_triton_batched
        return knn_select_triton_batched(query, ref, k, self_mode, nr)
    return jax.vmap(lambda q, r, n: knn_select_xla(
        q, r, k, self_mode=self_mode, nr=n))(query, ref, nr)


def bucket_size(n: int, quantum: int = BUCKET_QUANTUM) -> int:
    """Smallest row bucket >= n on the {1,1.25,1.5,1.75} x 2^j x quantum grid."""
    if n <= quantum:
        return quantum
    j = int(math.floor(math.log2(n / quantum)))
    base = quantum * (1 << j)
    for m in (1.0, 1.25, 1.5, 1.75, 2.0):
        b = int(base * m)
        if b >= n:
            return b
    return 2 * base  # unreachable


def bucket_size_pow2(n: int, quantum: int = BUCKET_QUANTUM) -> int:
    """Coarse power-of-two row bucket (>= n).

    For paths whose device compute is cheap relative to per-shape program
    compile/load cost (the device-resident refine pipeline): halves the
    number of distinct compiled shapes vs ``bucket_size`` at the price of
    up to ~2x padded compute."""
    b = quantum
    while b < n:
        b *= 2
    return b


def _pad_rows_np(x: np.ndarray, total: int) -> np.ndarray:
    if x.shape[0] == total:
        return x
    out = np.zeros((total,) + x.shape[1:], x.dtype)
    out[: x.shape[0]] = x
    return out


@functools.partial(jax.jit, static_argnames=("k", "self_mode", "block_size"))
def knn_select_xla(query: jnp.ndarray, ref: jnp.ndarray, k: int,
                   self_mode: bool = False, block_size: int = 2048,
                   nr=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Blocked exact kNN selection (pure XLA).

    Args:
      query: (Nq, d) points to find neighbours for.
      ref:   (Nr, d) points to search in.  In self mode query and ref must be
             the same array (row i of query == row i of ref).
      k:     neighbours to keep (includes the self match in self mode).
      self_mode: force the self pair (i, i) to distance 0 in slot 0.
      nr:    true number of valid reference rows (runtime value; rows beyond
             it are padding).  Defaults to ref.shape[0].

    Returns:
      (d2, idx): squared distances (Nq, k) ascending and reference-row indices
      (Nq, k).  Padded/absent slots carry +inf distance and index -1.
    """
    nq, d = query.shape
    if nr is None:
        nr = ref.shape[0]
    nr = jnp.asarray(nr, jnp.int32)
    k = min(k, ref.shape[0])
    block_size = min(block_size, max(128, ref.shape[0]))

    # Shift both sets by a common offset: distances are translation-invariant
    # and centred coordinates avoid f32 cancellation in the matmul identity.
    # Masked sum: ref rows >= nr carry NO contract beyond "never selected"
    # — non-zero padding must
    # not shift mu.
    _ok = (jnp.arange(ref.shape[0]) < nr)[:, None]
    mu = jnp.sum(jnp.where(_ok, ref, 0), axis=0, keepdims=True) / jnp.maximum(
        nr.astype(query.dtype), 1.0)
    q = query - mu
    r = ref - mu
    pad = (-r.shape[0]) % block_size
    if pad:
        r = jnp.concatenate([r, jnp.zeros((pad, d), r.dtype)], axis=0)
    nblocks = r.shape[0] // block_size
    r = r.reshape(nblocks, block_size, d)

    q_sq = jnp.sum(q * q, axis=1, keepdims=True)          # (Nq, 1)
    qrow = jnp.arange(nq, dtype=jnp.int32)[:, None]       # (Nq, 1)

    kb = min(k, block_size)
    inf = jnp.asarray(jnp.inf, q.dtype)

    def body(carry, inp):
        run_negd2, run_idx = carry
        blk_id, rblk = inp
        offset = blk_id * block_size
        r_sq = jnp.sum(rblk * rblk, axis=1)[None, :]      # (1, B)
        # full-f32 matmul: a reduced-precision product (bf16 or TF32) costs
        # ~1% distance error — unacceptable even for the fast mode.
        d2 = q_sq + r_sq - 2.0 * jnp.dot(
            q, rblk.T, precision=jax.lax.Precision.HIGHEST)  # (Nq, B)
        gidx = offset + jnp.arange(block_size, dtype=jnp.int32)[None, :]
        valid = gidx < nr
        d2 = jnp.where(valid, d2, inf)
        if self_mode:
            # pin the self pair below any genuine distance so it always wins
            # slot 0 (clamped back to 0 afterwards).
            d2 = jnp.where(gidx == qrow, -1.0, d2)
        neg_blk, loc = jax.lax.top_k(-d2, kb)             # largest -d2 = smallest d2
        blk_idx = jnp.take_along_axis(jnp.broadcast_to(gidx, d2.shape), loc, axis=1)
        blk_idx = jnp.where(neg_blk == -inf, -1, blk_idx)
        # merge with running top-k
        cat_neg = jnp.concatenate([run_negd2, neg_blk], axis=1)
        cat_idx = jnp.concatenate([run_idx, blk_idx], axis=1)
        run_negd2, pos = jax.lax.top_k(cat_neg, k)
        run_idx = jnp.take_along_axis(cat_idx, pos, axis=1)
        return (run_negd2, run_idx), None

    init = (jnp.full((nq, k), -jnp.inf, q.dtype),
            jnp.full((nq, k), -1, jnp.int32))
    (neg_d2, idx), _ = jax.lax.scan(
        body, init, (jnp.arange(nblocks, dtype=jnp.int32), r))
    d2 = jnp.maximum(-neg_d2, 0.0)                        # self slot: -1 -> 0
    return d2, idx


def center_f64(query64: np.ndarray,
               ref64: Optional[np.ndarray] = None):
    """Subtract the reference-set mean in f64 from both sets.

    Distances are translation-invariant, but a later f64->f32 cast loses
    |offset|*2^-24 absolute precision per coordinate — fatal for the f32
    selection ranking of strongly offset chains (whitening does not remove
    the mean; reference behaviour).  Returns (q_centred, r_centred) where
    r_centred is q_centred in self mode (``ref64=None``)."""
    q = np.asarray(query64, np.float64)
    r = q if ref64 is None else np.asarray(ref64, np.float64)
    mu = np.mean(r, axis=0)
    q = q - mu
    r = q if ref64 is None else r - mu
    return q, r


def guarded_refine_knn_f64(query64, ref64, idx, k, *, self_mode,
                           reselect=None, _retried=False) -> np.ndarray:
    """f64 candidate refinement + the candidate-sufficiency guard.

    Refines all candidates in ``idx`` and checks that the k-th refined
    distance sits inside the candidate boundary by more than the f32/packed
    ranking noise (~2^-11 relative); on a thin margin, calls
    ``reselect(k_sel)`` once for a larger candidate set, then warns
    (near-exact ties leave the evidence unchanged to O(tie gap)).
    """
    d_all = _refine_knn_f64_all(query64, ref64, idx, self_mode)
    d = d_all[:, :k]
    if d_all.shape[1] > k:
        boundary = d_all[:, -1]
        thin = ((d[:, k - 1] > boundary * (1.0 - 2.0 ** -10))
                & np.isfinite(boundary) & (boundary > 0))
        if thin.any():
            if reselect is not None and not _retried:
                k_sel = d_all.shape[1]
                logger.info(
                    "kNN candidate margin thin for %d/%d rows; re-selecting "
                    "with %d candidates", int(thin.sum()), len(d),
                    min(4 * k_sel + 8, ref64.shape[0]))
                idx2 = reselect(min(4 * k_sel + 8, ref64.shape[0]))
                return guarded_refine_knn_f64(query64, ref64, idx2, k,
                                              self_mode=self_mode,
                                              reselect=reselect,
                                              _retried=True)
            logger.warning(
                "kNN candidate margin thin for %d/%d rows (near-tied "
                "neighbour distances); parity may be limited by genuine "
                "ties, which leave the evidence unchanged to O(tie gap)",
                int(thin.sum()), len(d))
    return d


def refine_knn_f64(query64: np.ndarray, ref64: np.ndarray,
                   idx: np.ndarray, k: int,
                   self_mode: bool = False) -> np.ndarray:
    """Exact float64 distances for pre-selected candidates (host, numpy).

    Recomputes ||q - r||^2 with the difference form for every candidate in
    ``idx`` (Nq, k_sel >= k), re-sorts, and returns the k smallest distances
    per row as float64.  Cost is O(Nq * k_sel * d) — negligible next to the
    O(N^2 d) selection sweep.
    """
    return _refine_knn_f64_all(query64, ref64, idx, self_mode)[:, :k]


# peak host memory one refinement chunk may use for its (rows, k_sel, d)
# f64 workspace; chunking over query rows keeps the host-refine path (the
# overflow-proof fallback at the single-chip N ceiling) flat in RAM
_REFINE_CHUNK_BYTES = int(float(os.environ.get(
    "MCE_REFINE_CHUNK_MB", "256")) * 2 ** 20)


def _refine_knn_f64_all(query64, ref64, idx, self_mode) -> np.ndarray:
    """All candidate distances, refined in f64 and sorted ascending.

    Streams over query rows in ~_REFINE_CHUNK_BYTES chunks: the (rows,
    k_sel, d) difference workspace is the host-refine path's only
    N-proportional allocation, and this path is the designated fallback
    for chains too large for the device-resident program's HBM plan."""
    idx = np.asarray(idx)
    nq, k_sel = idx.shape
    d = query64.shape[1]
    # diff + einsum intermediates: ~3 live f64 buffers of (chunk, k_sel, d)
    rows_per_chunk = max(1, _REFINE_CHUNK_BYTES // max(3 * k_sel * d * 8, 1))
    out = np.empty((nq, k_sel), np.float64)
    for lo in range(0, nq, rows_per_chunk):
        hi = min(nq, lo + rows_per_chunk)
        ic = idx[lo:hi]
        safe = np.maximum(ic, 0)
        diff = query64[lo:hi, None, :] - ref64[safe]      # (chunk, k_sel, d)
        d2 = np.einsum("nkd,nkd->nk", diff, diff)
        d2[ic < 0] = np.inf
        if self_mode:
            d2[ic == np.arange(lo, hi)[:, None]] = 0.0
        d2.sort(axis=1)
        out[lo:hi] = d2
    return np.sqrt(out)


def exact_knn(query: np.ndarray, ref: Optional[np.ndarray], k: int,
              *, refine: bool = True, pad_candidates: int = 4,
              engine: str = "auto", select_dtype=jnp.float32,
              bucket: bool = True) -> np.ndarray:
    """Sorted kNN distances — the full parity pipeline.

    Args:
      query: (Nq, d) float64 whitened samples.
      ref:   (Nr, d) float64 whitened reference set, or None for self mode
             (auto-evidence: ref = query, self match included as column 0).
      k:     number of distance columns to return.
      refine: recompute candidate distances exactly in float64 (host).  When
        False the f32 device distances are returned directly (speed mode).
      pad_candidates: extra f32-selected candidates per row; guards against
        f32 rounding flipping the selection boundary before refinement.  A
        runtime sufficiency guard compares the refined k-th distance against
        the candidate boundary and re-runs once with 4x the padding if the
        margin is thinner than the selection's ranking noise.
      engine: one of ``ENGINES`` (see :func:`select_engine`).
      bucket: pad rows to the compile-bucket grid (the true counts are
        passed as runtime scalars).

    Returns:
      (Nq, k) float64 sorted ascending distances.
    """
    self_mode = ref is None
    ref64 = query if self_mode else ref
    nq, nr = query.shape[0], ref64.shape[0]
    k = min(k, nr)
    k_sel = min(nr, k + (pad_candidates if refine else 0))
    engine = select_engine(engine)

    q_np, r_np = center_f64(query, None if self_mode else ref64)
    if bucket:
        qb, rb = bucket_size(nq), bucket_size(nr)
        q_in = _pad_rows_np(q_np, qb)
        r_in = q_in if self_mode else _pad_rows_np(r_np, rb)
    else:
        q_in, r_in = q_np, r_np

    q32 = jnp.asarray(q_in, select_dtype)
    r32 = q32 if self_mode else jnp.asarray(r_in, select_dtype)

    def select(ks):
        return knn_select(q32, r32, ks, self_mode=self_mode, nr=nr,
                          engine=engine)

    d2, idx = select(k_sel)

    if refine:
        # only the candidate indices cross the (slow) device->host link;
        # distances are recomputed exactly in f64 anyway.  The candidate-
        # sufficiency guard + one re-selection retry live in
        # guarded_refine_knn_f64 (shared with the sharded paths).
        idx = np.asarray(idx)[:nq]
        if k_sel < nr:
            return guarded_refine_knn_f64(
                q_np, r_np, idx, k, self_mode=self_mode,
                reselect=lambda ks: np.asarray(select(ks)[1])[:nq])
        return _refine_knn_f64_all(q_np, r_np, idx, self_mode)[:, :k]
    return np.sqrt(np.asarray(d2, np.float64))[:nq, :k]

"""Multi-device evidence: ring-kNN over a device mesh.

The O(N^2 d) pairwise sweep is the "attention-score"-shaped computation of
this framework (SURVEY.md §2.4): queries stay resident, reference-sample
shards rotate around the ring via ``lax.ppermute`` while every device merges
a running top-k for its query shard — structurally ring attention, with a
k-selection instead of a softmax accumulator.  Whitening statistics are
combined with ``psum`` moments and the final evidence reduction is a
``psum``-logsumexp, so a full multi-chip evidence estimate is ONE jitted
SPMD program with no host round-trips.

This replaces the reference's two parallelism layers — sklearn's n_jobs
thread pool inside kneighbors and the MPI rank-per-dataset driver
(reference MCEvidence.py:1093-1104, planck_mcevidence.py:149-168) — with
sharding whose collectives XLA hands to the device interconnect.

Compile discipline: every jitted SPMD program is built ONCE per
(mesh, kmax, ndim) and cached at module level; chain length, true sample
counts and prior volumes are RUNTIME values (rows bucket-padded via
ops.knn.bucket_size), so one compile serves every chain in a bucket — the
same discipline as ops/knn.py and ops/pipeline.py.

Precision modes (mirroring the single-device facade, evidence.py):
* "fast":   everything stays on device in f32; ~1e-3 lnZ envelope.
* "refine": host f64 whitening -> f32 ring SELECTION ONLY (with extra
  candidates) -> candidate indices cross the link -> host f64 distance
  refinement + f64 estimator.  Matches the f64/sklearn oracle to ~1e-12,
  while the O(N^2) sweep stays sharded f32 on the devices.
"""

from __future__ import annotations

import functools
import logging
import math
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.estimator import log_ball_volume_const, log_evidence_from_knn_np
from ..ops.knn import bucket_size, center_f64, guarded_refine_knn_f64

logger = logging.getLogger(__name__)

_PROGRAM_CACHE: dict = {}


def _mesh_key(mesh: Mesh):
    return (tuple(d.id for d in mesh.devices.flat), mesh.devices.shape,
            tuple(mesh.axis_names))


def _ring_knn_local(q: jnp.ndarray, r: jnp.ndarray, k: int, axis: str,
                    n_global, self_mode: bool
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-device body: rotate ref shards around the ring, merge top-k.

    ``q``: (nq_loc, d) local query shard; ``r``: (nr_loc, d) local ref shard.
    ``n_global``: RUNTIME int32 scalar — true (unpadded) reference count.
    Global row ids are shard-major (device p owns rows [p*loc, (p+1)*loc)).
    Rows with global id >= n_global are padding and never selected.
    In self mode the (global) diagonal pair is pinned to -1 => slot 0.
    """
    p_idx = jax.lax.axis_index(axis)
    p_num = jax.lax.axis_size(axis)
    nq_loc = q.shape[0]
    nr_loc = r.shape[0]
    k = min(k, nr_loc * p_num)
    n_global = jnp.asarray(n_global, jnp.int32)

    q_sq = jnp.sum(q * q, axis=1, keepdims=True)
    qrow = p_idx * nq_loc + jnp.arange(nq_loc, dtype=jnp.int32)[:, None]
    perm = [(i, (i + 1) % p_num) for i in range(p_num)]

    # Sub-block each ring hop: the (nq_loc, nr_loc) distance tile would be
    # O(N^2/P^2) memory — fine for a big ring, fatal for small P (a single
    # chip at P=1 would materialize N x N).  A scan over SUB columns keeps
    # the live tile at (nq_loc, SUB) for any shard size.
    SUB = min(2048, nr_loc)
    pad_r = (-nr_loc) % SUB
    nsub = (nr_loc + pad_r) // SUB
    kb = min(k, SUB)

    def step(s, carry):
        run_negd2, run_idx, r_buf = carry
        # shard visiting us at step s originated on device (p - s) mod P
        src = jax.lax.rem(p_idx - s + p_num, p_num)
        offset = src * nr_loc
        rp = (jnp.concatenate(
            [r_buf, jnp.zeros((pad_r, r_buf.shape[1]), r_buf.dtype)])
            if pad_r else r_buf).reshape(nsub, SUB, -1)

        def sub(carry2, inp):
            run_negd2, run_idx = carry2
            blk_id, rblk = inp
            r_sq = jnp.sum(rblk * rblk, axis=1)[None, :]
            d2 = q_sq + r_sq - 2.0 * jnp.dot(
                q, rblk.T, precision=jax.lax.Precision.HIGHEST)
            lcol = blk_id * SUB + jnp.arange(SUB, dtype=jnp.int32)[None, :]
            gcol = offset + lcol
            d2 = jnp.where((lcol < nr_loc) & (gcol < n_global), d2, jnp.inf)
            if self_mode:
                d2 = jnp.where(gcol == qrow, -1.0, d2)
            neg_blk, loc = jax.lax.top_k(-d2, kb)
            blk_idx = jnp.take_along_axis(
                jnp.broadcast_to(gcol, d2.shape), loc, axis=1)
            blk_idx = jnp.where(jnp.isinf(neg_blk), -1, blk_idx)
            cat_neg = jnp.concatenate([run_negd2, neg_blk], axis=1)
            cat_idx = jnp.concatenate([run_idx, blk_idx], axis=1)
            run_negd2, pos = jax.lax.top_k(cat_neg, k)
            run_idx = jnp.take_along_axis(cat_idx, pos, axis=1)
            return (run_negd2, run_idx), None

        (run_negd2, run_idx), _ = jax.lax.scan(
            sub, (run_negd2, run_idx),
            (jnp.arange(nsub, dtype=jnp.int32), rp))
        r_buf = jax.lax.ppermute(r_buf, axis, perm)
        return run_negd2, run_idx, r_buf

    init = (jnp.full((nq_loc, k), -jnp.inf, q.dtype),
            jnp.full((nq_loc, k), -1, jnp.int32), r)
    run_negd2, run_idx, _ = jax.lax.fori_loop(0, p_num, step, init)
    return jnp.maximum(-run_negd2, 0.0), run_idx


def _whiten_local(s: jnp.ndarray, n_real, axis: str):
    """Distributed whitening: psum moments -> replicated eigh -> local apply.

    ``n_real``: (nq_loc,) 0/1 mask of genuine (non-padding) rows.
    Returns (whitened local shard, log_jacobian, posdef).
    """
    w = n_real[:, None]
    n = jax.lax.psum(jnp.sum(n_real), axis)
    sx = jax.lax.psum(jnp.sum(s * w, axis=0), axis)
    sxx = jax.lax.psum(jnp.dot((s * w).T, s, precision=jax.lax.Precision.HIGHEST), axis)
    mean = sx / n
    cov = (sxx - n * jnp.outer(mean, mean)) / (n - 1.0)
    eigvals, eigvecs = jnp.linalg.eigh(cov)
    posdef = jnp.all(eigvals > 0)
    safe = jnp.where(eigvals > 0, eigvals, 1.0)
    log_j = jnp.where(posdef, 0.5 * jnp.sum(jnp.log(safe)), 0.0)
    white = jnp.where(
        posdef,
        jnp.dot(s, eigvecs, precision=jax.lax.Precision.HIGHEST)
        / jnp.sqrt(safe), s)
    return white, log_j, posdef


def _reduce_mle(dknn2, lnlike, weights, valid, log_j, *, kmax, n_global,
                ndim, log_prior_volume, k_start, axis):
    """Distributed fused log-space reduction (ops/estimator.py semantics,
    psum/pmax across shards).  ``n_global`` / ``log_prior_volume`` are
    runtime scalars (int32 / f32)."""
    lnl_max = jax.lax.pmax(jnp.max(jnp.where(valid > 0, lnlike, -jnp.inf)),
                           axis)
    fs = lnlike - lnl_max
    log_c = log_ball_volume_const(ndim)
    log_d2 = jnp.where(dknn2 > 0, jnp.log(jnp.where(dknn2 > 0, dknn2, 1.0)),
                       -jnp.inf)
    log_terms = (log_c + 0.5 * ndim * log_d2
                 + (fs - jnp.log(weights))[:, None])
    log_terms = jnp.where(valid[:, None] > 0, log_terms, -jnp.inf)
    m = jax.lax.pmax(jnp.max(log_terms, axis=0), axis)          # (kmax,)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    sums = jax.lax.psum(jnp.sum(jnp.exp(log_terms - m_safe), axis=0), axis)
    log_dotp = m_safe + jnp.log(sums)
    sum_w = jax.lax.psum(jnp.sum(weights * valid), axis)
    k_idx = jnp.arange(kmax)
    k_nn = k_idx if k_start == 1 else k_idx + 1                 # quirk Q2 layout
    # S*k+1 via the f32 count: exact below 2^24 rows and ~2^-24 relative
    # beyond (an int32 product would overflow for n_global > 2^31/k —
    # exactly the huge-chain regime this multi-chip path exists for)
    denom = (jnp.asarray(n_global, log_dotp.dtype)
             * k_nn.astype(log_dotp.dtype) + 1.0)
    log_amax = log_dotp - jnp.log(denom)
    mle = (jnp.log(sum_w) + log_amax + log_j + lnl_max - log_prior_volume)
    return jnp.where(k_idx < k_start, 0.0, mle)


def _evidence_step_local(samples, lnlike, weights, valid, n_global,
                         log_prior_volume, *, kmax: int, ndim: int,
                         axis: str):
    """SPMD auto-evidence for a chain shard (runs under shard_map)."""
    white, log_j, _ = _whiten_local(samples, valid, axis)
    dknn2, _ = _ring_knn_local(white, white, kmax, axis, n_global,
                               self_mode=True)
    return _reduce_mle(dknn2, lnlike, weights, valid, log_j, kmax=kmax,
                       n_global=n_global, ndim=ndim,
                       log_prior_volume=log_prior_volume, k_start=1,
                       axis=axis)


def _cross_evidence_step_local(s1, lnl1, w1, valid1, s2, valid2, n1_global,
                               n2_global, log_prior_volume, *,
                               kmax: int, ndim: int, axis: str):
    """SPMD cross-evidence: NN of s1 shards searched in rotating s2 shards
    (reference split mode, MCEvidence.py:1073-1096; k0=0 semantics).

    Whitening uses the covariance of ALL samples (covtype='all', quirk Q1):
    moments of s1 and s2 are psum-combined before the eigh.
    """
    # combined moments over both partitions
    m1 = valid1[:, None]
    m2 = valid2[:, None]
    n = jax.lax.psum(jnp.sum(valid1) + jnp.sum(valid2), axis)
    sx = jax.lax.psum(jnp.sum(s1 * m1, axis=0) + jnp.sum(s2 * m2, axis=0),
                      axis)
    sxx = jax.lax.psum(
        jnp.dot((s1 * m1).T, s1, precision=jax.lax.Precision.HIGHEST)
        + jnp.dot((s2 * m2).T, s2, precision=jax.lax.Precision.HIGHEST),
        axis)
    mean = sx / n
    cov = (sxx - n * jnp.outer(mean, mean)) / (n - 1.0)
    eigvals, eigvecs = jnp.linalg.eigh(cov)
    posdef = jnp.all(eigvals > 0)
    safe = jnp.where(eigvals > 0, eigvals, 1.0)
    log_j = jnp.where(posdef, 0.5 * jnp.sum(jnp.log(safe)), 0.0)
    rot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
    w1s = jnp.where(posdef, rot(s1, eigvecs) / jnp.sqrt(safe), s1)
    w2s = jnp.where(posdef, rot(s2, eigvecs) / jnp.sqrt(safe), s2)
    dknn2, _ = _ring_knn_local(w1s, w2s, kmax, axis, n2_global,
                               self_mode=False)
    return _reduce_mle(dknn2, lnl1, w1, valid1, log_j, kmax=kmax,
                       n_global=n1_global, ndim=ndim,
                       log_prior_volume=log_prior_volume, k_start=0,
                       axis=axis)


# ---------------------------------------------------------------------------
# cached jitted SPMD programs (chain length / counts / volumes are runtime)
# ---------------------------------------------------------------------------

def make_sharded_evidence(mesh: Mesh, axis: str = "ring", *, kmax: int,
                          ndim: int):
    """Build (or fetch) the jitted multi-chip auto-evidence program.

    The returned function takes shard-major padded arrays
    (samples (Np, d), lnlike (Np,), weights (Np,), valid (Np,)) plus the
    RUNTIME scalars (n_global int32, log_prior_volume f32) and returns the
    (kmax,) MLE row (column 0 unused, matching the single-device layout).
    """
    key = ("auto", _mesh_key(mesh), axis, kmax, ndim)
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        body = functools.partial(_evidence_step_local, kmax=kmax, ndim=ndim,
                                 axis=axis)
        sharded = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(axis, None), P(axis), P(axis), P(axis), P(), P()),
            out_specs=P(),
            check_vma=False)
        fn = jax.jit(sharded)
        _PROGRAM_CACHE[key] = fn
    return fn


def make_sharded_cross_evidence(mesh: Mesh, axis: str = "ring", *, kmax: int,
                                ndim: int):
    """Build (or fetch) the jitted multi-chip cross-evidence program.

    Takes shard-major padded arrays (s1 (N1p, d), lnl1, w1, valid1,
    s2 (N2p, d), valid2) plus runtime scalars (n1_global, n2_global,
    log_prior_volume) and returns the (kmax,) MLE row with k0=0 columns
    (caller slices [1:], preserving quirk Q2)."""
    key = ("cross", _mesh_key(mesh), axis, kmax, ndim)
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        body = functools.partial(_cross_evidence_step_local, kmax=kmax,
                                 ndim=ndim, axis=axis)
        sharded = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(axis, None), P(axis), P(axis), P(axis),
                      P(axis, None), P(axis), P(), P(), P()),
            out_specs=P(),
            check_vma=False)
        fn = jax.jit(sharded)
        _PROGRAM_CACHE[key] = fn
    return fn


def make_sharded_knn(mesh: Mesh, axis: str = "ring", *, k: int,
                     self_mode: bool):
    """Build (or fetch) the jitted sharded kNN SELECTION program.

    fn(q (Nqp, d), r (Nrp, d), n_global int32) -> (d2 (Nqp, k) f32,
    idx (Nqp, k) int32 global row ids).  This is the multi-chip counterpart
    of ops.knn.knn_select_xla: selection only, so the host can refine the
    candidates in f64 for parity-grade accuracy (only the small index
    matrix crosses the link)."""
    key = ("knn", _mesh_key(mesh), axis, k, self_mode)
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        def body(q, r, n_global):
            return _ring_knn_local(q, r, k, axis, n_global,
                                   self_mode=self_mode)
        sharded = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P()),
            out_specs=(P(axis, None), P(axis, None)),
            check_vma=False)
        fn = jax.jit(sharded)
        _PROGRAM_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# host-facing wrappers
# ---------------------------------------------------------------------------

def pad_for_mesh(samples: np.ndarray, lnlike: np.ndarray,
                 weights: Optional[np.ndarray], n_devices: int,
                 bucket: bool = True):
    """Pad arrays so each device gets an equal shard; returns
    (s, lnl, w, valid).  With ``bucket=True`` rows are first padded up to
    the ops.knn compile-bucket grid so one compile serves every chain in a
    bucket (true counts travel as runtime scalars)."""
    n, d = samples.shape
    if weights is None:
        weights = np.ones(n)
    total = bucket_size(n) if bucket else n
    total = ((total + n_devices - 1) // n_devices) * n_devices
    npad = total - n
    s = np.concatenate([samples, np.zeros((npad, d))], axis=0)
    lnl = np.concatenate([lnlike, np.full(npad, -1e30)])
    w = np.concatenate([weights, np.ones(npad)])
    valid = np.concatenate([np.ones(n), np.zeros(npad)])
    return s, lnl, w, valid


def _pad_rows(arr: np.ndarray, total: int) -> np.ndarray:
    npad = total - arr.shape[0]
    if npad <= 0:
        return arr
    return np.concatenate([arr, np.zeros((npad,) + arr.shape[1:],
                                         arr.dtype)])


def _default_mesh(mesh: Optional[Mesh]) -> Mesh:
    if mesh is None:
        devs = np.array(jax.local_devices())   # local: under jax.distributed
        # each process runs its own independent per-dataset programs
        mesh = Mesh(devs, ("ring",))
    return mesh


def _default_grid_mesh(mesh: Optional[Mesh]) -> Mesh:
    """Default 2-D (dp x ring) mesh: all local devices on the ring axis
    (local, not global: under jax.distributed each process runs its own
    independent per-dataset programs)."""
    if mesh is None:
        devs = np.array(jax.local_devices())
        mesh = Mesh(devs.reshape(1, -1), ("dp", "ring"))
    return mesh


def sharded_knn_candidates(query64: np.ndarray, ref64: Optional[np.ndarray],
                           k_sel: int, *, mesh: Mesh,
                           dtype=jnp.float32) -> np.ndarray:
    """Ring-select k_sel candidate indices for (already whitened) f64 points.

    ``ref64=None`` means self mode (auto evidence).  Returns (Nq, k_sel)
    int32 global row indices into the reference set (-1 = absent).
    """
    axis = mesh.axis_names[-1]
    pcount = mesh.shape[axis]
    self_mode = ref64 is None
    # centre in f64 before the f32 cast (translation-invariant; preserves
    # the f32 ranking precision for strongly offset coordinates)
    query64, r64 = center_f64(query64, ref64)
    nq, nr = query64.shape[0], r64.shape[0]
    qb = ((bucket_size(nq) + pcount - 1) // pcount) * pcount
    rb = qb if self_mode else ((bucket_size(nr) + pcount - 1) // pcount) * pcount
    q_in = _pad_rows(np.asarray(query64, np.float64), qb)
    r_in = q_in if self_mode else _pad_rows(np.asarray(r64, np.float64), rb)

    fn = make_sharded_knn(mesh, axis, k=min(k_sel, nr), self_mode=self_mode)
    sh2 = NamedSharding(mesh, P(axis, None))
    q_dev = jax.device_put(jnp.asarray(q_in, dtype), sh2)
    r_dev = q_dev if self_mode else jax.device_put(jnp.asarray(r_in, dtype),
                                                   sh2)
    _, idx = fn(q_dev, r_dev, jnp.asarray(nr, jnp.int32))
    return np.asarray(idx)[:nq]


def sharded_auto_evidence(samples: np.ndarray, lnlike: np.ndarray,
                          weights: Optional[np.ndarray] = None,
                          *, kmax: int = 5, prior_volume: float = 1.0,
                          sum_adjusted_weights: Optional[float] = None,
                          mesh: Optional[Mesh] = None,
                          precision: str = "fast",
                          pad_candidates: int = 4,
                          dtype=jnp.float32) -> np.ndarray:
    """Multi-device auto evidence (same contract as ``evidence_fn``):
    returns ln Z for k = 1..kmax-1.

    ``precision='fast'``: one fused SPMD program, all-f32 on device.
    ``precision='refine'``: host f64 whitening, sharded f32 ring selection
    of kmax+pad_candidates candidates, host f64 refinement + estimator —
    the parity path (<1e-6 vs the sklearn/f64 oracle) at multi-chip scale.
    """
    kmax = max(2, kmax)
    mesh = _default_mesh(mesh)
    axis = mesh.axis_names[-1]
    pcount = mesh.shape[axis]
    n, ndim = samples.shape
    samples = np.asarray(samples, np.float64)
    lnlike = np.asarray(lnlike, np.float64)
    w_np = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    sumw = float(np.sum(w_np)) if sum_adjusted_weights is None \
        else float(sum_adjusted_weights)

    if precision == "refine":
        from ..ops.whiten import apply_whiten, whiten_stats
        stats = whiten_stats(samples)
        s1w = apply_whiten(samples, stats)
        idx = sharded_knn_candidates(s1w, None,
                                     min(n, kmax + pad_candidates),
                                     mesh=mesh, dtype=dtype)
        dknn = guarded_refine_knn_f64(
            s1w, s1w, idx, min(kmax, n), self_mode=True,
            reselect=lambda ks: sharded_knn_candidates(
                s1w, None, ks, mesh=mesh, dtype=dtype))
        mle = log_evidence_from_knn_np(
            dknn, lnlike, w_np, sumw, ndim,
            log_jacobian=stats.log_jacobian,
            log_prior_volume=math.log(prior_volume), k_start=1, nsamples=n)
        # n < kmax: only the first n-1 neighbour columns exist; the rest
        # are NaN (same convention as _device_refine_finalize), keeping the
        # documented kmax-1 return width
        out = np.full(kmax - 1, np.nan)
        out[: len(mle) - 1] = mle[1:]
        return out

    # centre in f64 before the f32 cast (translation-invariant; preserves
    # selection ranking and covariance conditioning for offset chains)
    samples = samples - samples.mean(axis=0)
    s, lnl, w, valid = pad_for_mesh(samples, lnlike, w_np, pcount)
    fn = make_sharded_evidence(mesh, axis, kmax=kmax, ndim=ndim)
    sharding = NamedSharding(mesh, P(axis))
    sharding2 = NamedSharding(mesh, P(axis, None))
    s_dev = jax.device_put(jnp.asarray(s, dtype), sharding2)
    args = [jax.device_put(jnp.asarray(a, dtype), sharding)
            for a in (lnl, w, valid)]
    mle = np.asarray(fn(s_dev, *args, jnp.asarray(n, jnp.int32),
                        jnp.asarray(math.log(prior_volume), dtype)),
                     np.float64)
    if sum_adjusted_weights is not None:
        # importance reweighting enters only through SumW (quirk Q7)
        shift = np.log(sumw) - np.log(float(np.sum(w_np)))
        mle[1:] = mle[1:] + shift
    if n < kmax:
        # column k needs a k-th non-self neighbour (n-1 >= k): beyond that
        # the padded +inf distances would otherwise surface as +inf lnZ
        mle[n:] = np.nan
    return mle[1:]


def sharded_cross_evidence(samples1: np.ndarray, lnlike1: np.ndarray,
                           samples2: np.ndarray,
                           weights1: Optional[np.ndarray] = None,
                           *, kmax: int = 5, prior_volume: float = 1.0,
                           sum_adjusted_weights: Optional[float] = None,
                           mesh: Optional[Mesh] = None,
                           precision: str = "fast",
                           pad_candidates: int = 4,
                           dtype=jnp.float32) -> np.ndarray:
    """Multi-device cross evidence (same contract as ``evidence_fn`` with
    ``samples2``): returns ln Z for k = 1..kmax-1.  See
    ``sharded_auto_evidence`` for the precision modes."""
    kmax = max(2, kmax)
    mesh = _default_mesh(mesh)
    axis = mesh.axis_names[-1]
    pcount = mesh.shape[axis]
    n1, ndim = samples1.shape
    n2 = samples2.shape[0]
    samples1 = np.asarray(samples1, np.float64)
    samples2 = np.asarray(samples2, np.float64)
    lnlike1 = np.asarray(lnlike1, np.float64)
    w1_np = (np.ones(n1) if weights1 is None
             else np.asarray(weights1, np.float64))
    sumw = float(np.sum(w1_np)) if sum_adjusted_weights is None \
        else float(sum_adjusted_weights)

    if precision == "refine":
        from ..ops.whiten import apply_whiten, whiten_stats
        # covtype='all' (quirk Q1): one covariance over both partitions
        stats = whiten_stats(np.concatenate([samples1, samples2]))
        s1w = apply_whiten(samples1, stats)
        s2w = apply_whiten(samples2, stats)
        idx = sharded_knn_candidates(s1w, s2w,
                                     min(n2, kmax + pad_candidates),
                                     mesh=mesh, dtype=dtype)
        dknn = guarded_refine_knn_f64(
            s1w, s2w, idx, min(kmax, n2), self_mode=False,
            reselect=lambda ks: sharded_knn_candidates(
                s1w, s2w, ks, mesh=mesh, dtype=dtype))
        mle = log_evidence_from_knn_np(
            dknn, lnlike1, w1_np, sumw, ndim,
            log_jacobian=stats.log_jacobian,
            log_prior_volume=math.log(prior_volume), k_start=0, nsamples=n1)
        # n2 < kmax: only the first n2 reference-neighbour columns exist
        out = np.full(kmax - 1, np.nan)
        out[: len(mle) - 1] = mle[1:]
        return out

    # common f64 shift for BOTH partitions (cross distances are relative)
    mu_c = samples1.mean(axis=0)
    samples1 = samples1 - mu_c
    samples2 = samples2 - mu_c
    s1, lnl1, w1, valid1 = pad_for_mesh(samples1, lnlike1, w1_np, pcount)
    nb2 = ((bucket_size(n2) + pcount - 1) // pcount) * pcount
    s2 = _pad_rows(samples2, nb2)
    valid2 = np.concatenate([np.ones(n2), np.zeros(nb2 - n2)])
    fn = make_sharded_cross_evidence(mesh, axis, kmax=kmax, ndim=ndim)
    sh1 = NamedSharding(mesh, P(axis))
    sh2 = NamedSharding(mesh, P(axis, None))
    args = (jax.device_put(jnp.asarray(s1, dtype), sh2),
            jax.device_put(jnp.asarray(lnl1, dtype), sh1),
            jax.device_put(jnp.asarray(w1, dtype), sh1),
            jax.device_put(jnp.asarray(valid1, dtype), sh1),
            jax.device_put(jnp.asarray(s2, dtype), sh2),
            jax.device_put(jnp.asarray(valid2, dtype), sh1),
            jnp.asarray(n1, jnp.int32), jnp.asarray(n2, jnp.int32),
            jnp.asarray(math.log(prior_volume), dtype))
    mle = np.asarray(fn(*args), np.float64)
    if sum_adjusted_weights is not None:
        shift = np.log(sumw) - np.log(float(np.sum(w1_np)))
        mle = mle + shift
    if n2 < kmax:
        # cross column c uses the (c+1)-th reference neighbour (k0=0):
        # undefined once c+1 > n2 — NaN instead of padded +inf
        mle[n2:] = np.nan
    return mle[1:]


def make_sharded_device_refine(mesh: Mesh, axis: str = "ring", *,
                               k_sel: int, kmax: int, engine: str,
                               self_mode: bool = True):
    """Multi-chip device-resident parity program: query rows sharded over
    ``axis``, the reference set replicated (HBM easily holds any chain),
    each device running the fused selection + double-float
    refinement + double-float partial estimator on its shard, partials
    all-gathered.  Only a (P, 2*kmax+1) array of scalars leaves the mesh —
    the multi-chip counterpart of ops.pipeline.fused_refine_dotp.
    """
    key = ("devref", _mesh_key(mesh), axis, k_sel, kmax, engine, self_mode)
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        from ..ops.pipeline import _fused_refine_dotp_impl

        def body(qhi, qlo, rhi, rlo, scalh, scall, valid, n_ref, ndim,
                 inv_s2):
            p_idx = jax.lax.axis_index(axis)
            offset = (p_idx * qhi.shape[0]).astype(jnp.int32)
            flat = _fused_refine_dotp_impl(
                qhi, qlo, rhi, rlo, scalh, scall, valid, n_ref, ndim,
                inv_s2, offset, k_sel=k_sel, kmax=kmax, engine=engine,
                self_mode=self_mode, kernel_self_pin=False)
            return jax.lax.all_gather(flat, axis)

        sharded = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P(None, None),
                      P(None, None), P(axis), P(axis), P(axis),
                      P(), P(), P()),
            out_specs=P(),
            check_vma=False)
        fn = jax.jit(sharded)
        _PROGRAM_CACHE[key] = fn
    return fn


def sharded_device_refine_evidence(samples: np.ndarray, lnlike: np.ndarray,
                                   weights: Optional[np.ndarray] = None, *,
                                   samples2: Optional[np.ndarray] = None,
                                   kmax: int = 2, prior_volume: float = 1.0,
                                   sum_adjusted_weights=None,
                                   pad_candidates: int = 4,
                                   mesh: Optional[Mesh] = None,
                                   engine: str = "auto") -> np.ndarray:
    """Multi-device 'device' precision evidence: host f64 whitening,
    double-float upload, sharded fused selection+refinement+estimator,
    scalars-only fetch, f64 host bookkeeping.  Returns k = 1..kmax-1.
    Auto mode, or cross when ``samples2`` is given."""
    from ..ops.pipeline import (DEVICE_NDIM_MAX, _device_refine_finalize,
                                _device_refine_prepare)
    kmax = max(2, kmax)
    mesh = _default_mesh(mesh)
    axis = mesh.axis_names[-1]
    if samples.shape[1] > DEVICE_NDIM_MAX:
        # wider than the device dpad layout classes: degrade to the sharded
        # refine path like every other unsupported device-path config
        logger.info("sharded device-refine: ndim %d > %d; falling back to "
                    "the sharded refine path", samples.shape[1],
                    DEVICE_NDIM_MAX)
        if samples2 is None:
            return sharded_auto_evidence(
                samples, lnlike, weights, kmax=kmax,
                prior_volume=prior_volume,
                sum_adjusted_weights=sum_adjusted_weights, mesh=mesh,
                precision="refine", pad_candidates=pad_candidates)
        return sharded_cross_evidence(
            samples, lnlike, samples2, weights, kmax=kmax,
            prior_volume=prior_volume,
            sum_adjusted_weights=sum_adjusted_weights, mesh=mesh,
            precision="refine", pad_candidates=pad_candidates)
    dev, host = _device_refine_prepare(samples, lnlike, weights, kmax,
                                       pad_candidates, engine,
                                       samples2=samples2)
    # kmax_eff, not kmax: tiny reference partitions cap the candidate count
    # (the single-device path passes the same, pipeline.py fused call) —
    # a raw kmax would slice past the argsort width inside the program
    fn = make_sharded_device_refine(mesh, axis, k_sel=host["k_sel"],
                                    kmax=host["kmax_eff"],
                                    engine=host["engine"],
                                    self_mode=samples2 is None)
    shq = NamedSharding(mesh, P(axis, None))
    sh1 = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    rep2 = NamedSharding(mesh, P(None, None))
    parts = np.asarray(fn(
        jax.device_put(dev["qhi"], shq), jax.device_put(dev["qlo"], shq),
        jax.device_put(dev["rhi"], rep2), jax.device_put(dev["rlo"], rep2),
        jax.device_put(dev["scalh"], sh1), jax.device_put(dev["scall"], sh1),
        jax.device_put(dev["valid"], sh1),
        jax.device_put(dev["n_true"], rep), jax.device_put(dev["ndim"], rep),
        jax.device_put(dev["inv_s2"], rep)), np.float64)
    # combine the per-device double-float partials exactly in host f64
    ke = host["kmax_eff"]
    vals = parts[:, :ke].sum(axis=0) + parts[:, ke:2 * ke].sum(axis=0)
    thin = parts[:, -1].sum()
    n_ref = samples2.shape[0] if samples2 is not None else samples.shape[0]
    if not np.all(np.isfinite(vals)):
        # double-float overflow (z^(ndim/2) left f32 range): same fallback
        # as the single-device path (pipeline.py) and the grid sibling —
        # the sharded refine program has unlimited range on the host side
        logger.warning("sharded device-refine: double-float overflow; "
                       "falling back to the sharded refine path")
        if samples2 is None:
            return sharded_auto_evidence(
                samples, lnlike, weights, kmax=kmax,
                prior_volume=prior_volume,
                sum_adjusted_weights=sum_adjusted_weights, mesh=mesh,
                precision="refine", pad_candidates=pad_candidates)
        return sharded_cross_evidence(
            samples, lnlike, samples2, weights, kmax=kmax,
            prior_volume=prior_volume,
            sum_adjusted_weights=sum_adjusted_weights, mesh=mesh,
            precision="refine", pad_candidates=pad_candidates)
    if thin > 0 and host["k_sel"] < n_ref:
        retry_pad = 4 * pad_candidates + 8
        if (pad_candidates < 32
                and min(kmax + retry_pad, n_ref) > host["k_sel"]):
            # thin candidate margins: one retry with 4x padding (same
            # policy as the single-device device path)
            logger.info("sharded device-refine: thin margins on %d rows; "
                        "re-running with %d extra candidates", int(thin),
                        retry_pad)
            return sharded_device_refine_evidence(
                samples, lnlike, weights, samples2=samples2, kmax=kmax,
                prior_volume=prior_volume,
                sum_adjusted_weights=sum_adjusted_weights,
                pad_candidates=retry_pad, mesh=mesh, engine=engine)
    flat = np.concatenate([vals, np.zeros(ke), [thin]])
    return _device_refine_finalize(flat, host, kmax, prior_volume,
                                   sum_adjusted_weights,
                                   warn_thin=host["k_sel"] < n_ref)


# ---------------------------------------------------------------------------
# 2-D mesh: data-parallel over chains x ring over samples
# ---------------------------------------------------------------------------

def make_sharded_grid_evidence(mesh: Mesh, axes=("dp", "ring"), *, kmax: int,
                               ndim: int):
    """Build the jitted 2-D-mesh program: a BATCH of chains, sharded over the
    ``dp`` axis (the embarrassing model x dataset grid axis the reference
    used MPI ranks for), each chain's samples ring-sharded over ``ring``.

    Takes stacked padded arrays (B, Np, d) / (B, Np) ... plus per-chain
    true counts (B,) int32 and log prior volumes (B,); returns (B, kmax)
    MLE rows.  B must be a multiple of the dp axis size; Np of the ring
    axis size.
    """
    dp, ring = axes
    # one jitted program per (mesh, kmax, ndim): rebuilding the shard_map
    # closure per call would defeat JAX's jit cache and recompile
    # identical-shape programs on every dataset.
    key = ("grid", _mesh_key(mesh), axes, kmax, ndim)
    cached = _PROGRAM_CACHE.get(key)
    if cached is not None:
        return cached

    def single(s, lnl, w, v, n_glob, log_pv, sumw_shift):
        mle = _evidence_step_local(
            s, lnl, w, v, n_glob, log_pv, kmax=kmax, ndim=ndim, axis=ring)
        # importance reweighting enters only through SumW (quirk Q7):
        # applied as a per-chain log shift ln(SumW_adj / SumW).
        k_idx = jnp.arange(kmax)
        return jnp.where(k_idx < 1, mle, mle + sumw_shift)

    batched = jax.vmap(single, in_axes=(0, 0, 0, 0, 0, 0, 0))
    sharded = jax.shard_map(
        batched, mesh=mesh,
        in_specs=(P(dp, ring, None), P(dp, ring), P(dp, ring), P(dp, ring),
                  P(dp), P(dp), P(dp)),
        out_specs=P(dp),
        check_vma=False)
    fn = jax.jit(sharded)
    _PROGRAM_CACHE[key] = fn
    return fn


def make_sharded_grid_knn(mesh: Mesh, axes=("dp", "ring"), *, k: int,
                          self_mode: bool = True):
    """Batched sharded kNN selection: a batch of chains over ``dp``, each
    ring-sharded; whitening happens on the HOST (f64) so the returned
    candidate indices support f64 refinement — the parity-grade counterpart
    of ``make_sharded_grid_evidence``.

    fn(Q (B, Np, d), R (B, Mp, d), NG_ref (B,) int32)
        -> (d2 (B, Np, k), idx (B, Np, k)).
    In self mode pass R = Q (auto evidence); cross mode searches each
    chain's queries in its own reference partition (k0=0 semantics).
    """
    dp, ring = axes
    key = ("grid_knn", _mesh_key(mesh), axes, k, self_mode)
    cached = _PROGRAM_CACHE.get(key)
    if cached is not None:
        return cached

    def single(q, r, n_glob):
        return _ring_knn_local(q, r, k, ring, n_glob, self_mode=self_mode)

    batched = jax.vmap(single, in_axes=(0, 0, 0))
    sharded = jax.shard_map(
        batched, mesh=mesh,
        in_specs=(P(dp, ring, None), P(dp, ring, None), P(dp)),
        out_specs=(P(dp, ring, None), P(dp, ring, None)),
        check_vma=False)
    fn = jax.jit(sharded)
    _PROGRAM_CACHE[key] = fn
    return fn


def _normalize_chains(chains):
    norm = []
    for c in chains:
        if isinstance(c, dict):
            s = np.asarray(c["samples"], np.float64)
            l = np.asarray(c["loglikes"], np.float64)
            w = np.asarray(c.get("weights", np.ones(len(s))), np.float64)
        else:
            s = np.asarray(c[0], np.float64)
            l = np.asarray(c[1], np.float64)
            w = (np.asarray(c[2], np.float64) if len(c) > 2
                 else np.ones(len(s)))
        norm.append((s, l, w))
    return norm


def _grid_batch_layout(norm, mesh, pow2_rows: bool = False):
    """Common padded-batch geometry for the 2-D-mesh programs.

    ``pow2_rows``: coarse power-of-two row buckets (the device-refine
    discipline, matching ``_device_refine_prepare``) instead of the default
    finer ``bucket_size`` steps."""
    from ..ops.knn import bucket_size_pow2
    dp_n = mesh.shape["dp"]
    ring_n = mesh.shape["ring"]
    b_true = len(norm)
    ndim = norm[0][0].shape[1]
    rows = max(s.shape[0] for s, _, _ in norm)
    n_pad = bucket_size_pow2(rows) if pow2_rows else bucket_size(rows)
    n_pad = ((n_pad + ring_n - 1) // ring_n) * ring_n
    # bucket the batch axis too (next power of two, then dp-divisible):
    # every distinct (B, Np, d) is its own multi-minute remote compile.
    b_pad = 1
    while b_pad < b_true:
        b_pad *= 2
    b_pad = ((b_pad + dp_n - 1) // dp_n) * dp_n
    return b_true, b_pad, n_pad, ndim


def sharded_grid_auto_evidence(chains, *, kmax: int = 2,
                               prior_volumes=None,
                               sumw_log_shifts=None,
                               mesh: Optional[Mesh] = None,
                               dtype=jnp.float32) -> np.ndarray:
    """Auto evidence for MANY chains in one SPMD program (f32 fast path).

    ``chains``: sequence of (samples, lnlike[, weights]) tuples (or dicts
    with those keys).  All chains are padded to a common bucketed length and
    the batch is padded to the dp axis size; padding chains/rows never
    contribute.  Returns (len(chains), kmax-1) ln Z values.
    """
    from ..utils.cache import enable_compilation_cache
    enable_compilation_cache()
    kmax = max(2, kmax)
    mesh = _default_grid_mesh(mesh)
    norm = _normalize_chains(chains)
    b_true, b_pad, n_pad, ndim = _grid_batch_layout(norm, mesh)
    if prior_volumes is None:
        prior_volumes = np.ones(b_true)

    S = np.zeros((b_pad, n_pad, ndim))
    L = np.full((b_pad, n_pad), -1e30)
    W = np.ones((b_pad, n_pad))
    V = np.zeros((b_pad, n_pad))
    NG = np.ones(b_pad, np.int32)
    LPV = np.zeros(b_pad)
    SWS = np.zeros(b_pad)
    if sumw_log_shifts is not None:
        SWS[:b_true] = np.asarray(sumw_log_shifts, np.float64)
    for i, (s, l, w) in enumerate(norm):
        n = s.shape[0]
        S[i, :n] = s
        L[i, :n] = l
        W[i, :n] = w
        V[i, :n] = 1.0
        NG[i] = n
        LPV[i] = math.log(prior_volumes[i])
    # padding chains: one fake valid row so reductions stay finite
    for i in range(b_true, b_pad):
        V[i, 0] = 1.0
        L[i, 0] = 0.0

    from ..utils.cache import record_shape
    record_shape("grid_fast", batch=b_pad, rows=n_pad, ndim=ndim, kmax=kmax)
    fn = make_sharded_grid_evidence(mesh, ("dp", "ring"), kmax=kmax,
                                    ndim=ndim)
    sh3 = NamedSharding(mesh, P("dp", "ring", None))
    sh2 = NamedSharding(mesh, P("dp", "ring"))
    sh1 = NamedSharding(mesh, P("dp"))
    args = (jax.device_put(jnp.asarray(S, dtype), sh3),
            jax.device_put(jnp.asarray(L, dtype), sh2),
            jax.device_put(jnp.asarray(W, dtype), sh2),
            jax.device_put(jnp.asarray(V, dtype), sh2),
            jax.device_put(jnp.asarray(NG), sh1),
            jax.device_put(jnp.asarray(LPV, dtype), sh1),
            jax.device_put(jnp.asarray(SWS, dtype), sh1))
    mle = np.asarray(fn(*args))
    return mle[:b_true, 1:]


# Fixed coordinate widths for the refine-mode selection program: whitened
# coords are zero-padded to the next width class (zero columns leave pairwise
# distances unchanged), so a handful of compiled programs serve every ndim —
# the Planck grid mixes ndim 6..9.  Two classes (not one): padding ndim<=8
# to 16 columns would double the upload bytes of the dominant grid cells.
GRID_DPAD_CLASSES = (8, 16)
GRID_DPAD = GRID_DPAD_CLASSES[-1]


def _dpad_class(ndim: int) -> int:
    for w in GRID_DPAD_CLASSES:
        if ndim <= w:
            return w
    raise ValueError(f"ndim {ndim} > GRID_DPAD {GRID_DPAD}")
# Fixed batch quantum: chains are processed in chunks of exactly this many,
# killing the batch dimension as a compile-shape degree of freedom.  Kept
# small because padding chains upload real (zero) bytes.
GRID_BATCH_QUANTUM = 4


def sharded_grid_evidence_refine(chains, *, kmax: int = 2,
                                 prior_volumes=None,
                                 sum_adjusted_weights=None,
                                 chains2=None,
                                 pad_candidates: int = 4,
                                 mesh: Optional[Mesh] = None,
                                 dtype=jnp.float32) -> np.ndarray:
    """Parity-grade batched evidence: host f64 whitening per chain, batched
    SPMD selection programs for the O(N^2) sweeps, host f64 candidate
    refinement + f64 estimator.  Returns (len(chains), kmax-1).

    Auto mode when ``chains2`` is None; cross mode when ``chains2`` is a
    matching sequence of reference-partition sample arrays (per-chain NNs
    of s1 searched in s2, k0=0 semantics; whitening uses the combined
    s1+s2 covariance — covtype='all', quirk Q1).

    Matches the sklearn/f64 oracle to ~1e-12 while keeping the per-cell
    device cost of the fast grid mode (only int32 candidate indices cross
    the device->host link beyond the sample upload).  Chains may mix
    dimensionalities (coords are zero-padded to GRID_DPAD columns) and are
    processed in GRID_BATCH_QUANTUM-sized chunks, so the whole Planck grid
    needs one compile per (row-bucket, k_sel) only.
    """
    from ..ops.whiten import apply_whiten, whiten_stats
    from ..utils.cache import enable_compilation_cache
    enable_compilation_cache()
    kmax = max(2, kmax)
    mesh = _default_grid_mesh(mesh)
    dp_n = mesh.shape["dp"]
    ring_n = mesh.shape["ring"]
    norm = _normalize_chains(chains)
    b_true = len(norm)
    ndims = [s.shape[1] for s, _, _ in norm]
    if max(ndims) > GRID_DPAD:
        raise ValueError(f"ndim {max(ndims)} > GRID_DPAD {GRID_DPAD}")
    if prior_volumes is None:
        prior_volumes = np.ones(b_true)
    cross = chains2 is not None
    if cross:
        refs = [np.asarray(s2, np.float64) for s2 in chains2]
        if len(refs) != b_true:
            raise ValueError("chains2 must match chains 1:1")
        n_refs = [r.shape[0] for r in refs]
    else:
        refs = None
        n_refs = [s.shape[0] for s, _, _ in norm]

    # cap by the LARGEST reference partition, not the smallest: the batched
    # selection masks per-chain absent candidates (rows >= the chain's true
    # count come back idx=-1/+inf and are excluded downstream), so a small
    # chain in the batch must not starve the large chains of candidates —
    # nor disable their thin-margin retry (round-4 review finding)
    k_sel = min(kmax + pad_candidates, max(n_refs))
    q_white = []
    r_white = []
    stats_list = []
    for i, (s, l, w) in enumerate(norm):
        if cross:
            stats = whiten_stats(np.concatenate([s, refs[i]]))
            rw = apply_whiten(refs[i], stats)
        else:
            stats = whiten_stats(s)
        qw = apply_whiten(s, stats)
        # centre in f64 (common shift per chain): keeps the f32 selection
        # ranking precise for strongly offset coordinates
        qw, rw_c = center_f64(qw, rw if cross else None)
        if cross:
            r_white.append(rw_c)
        q_white.append(qw)
        stats_list.append(stats)

    # chunked selection: fixed batch size, width-class coords, bucketed rows.
    # Every chunk is DISPATCHED before any result is fetched — jax's async
    # dispatch then pipelines chunk i+1's H2D transfer under chunk i's
    # compute, which matters enormously on a slow host<->device link.
    chunk = math.lcm(GRID_BATCH_QUANTUM, dp_n)   # divisible by the dp axis
    fn = make_sharded_grid_knn(mesh, ("dp", "ring"), k=k_sel,
                               self_mode=not cross)
    sh3 = NamedSharding(mesh, P("dp", "ring", None))
    sh1 = NamedSharding(mesh, P("dp"))
    by_class: dict = {}
    for i in range(b_true):
        by_class.setdefault(_dpad_class(ndims[i]), []).append(i)
    pending = []            # (members, idx device array)
    for dpad, indices in by_class.items():
        for c0 in range(0, len(indices), chunk):
            members = indices[c0:c0 + chunk]
            n_pad = bucket_size(max(q_white[i].shape[0] for i in members))
            n_pad = ((n_pad + ring_n - 1) // ring_n) * ring_n
            if cross:
                m_pad = bucket_size(max(n_refs[i] for i in members))
                m_pad = ((m_pad + ring_n - 1) // ring_n) * ring_n
            else:
                m_pad = n_pad
            Q = np.zeros((chunk, n_pad, dpad), np.float32)
            R = Q if not cross else np.zeros((chunk, m_pad, dpad),
                                             np.float32)
            NG = np.ones(chunk, np.int32)
            for b, i in enumerate(members):
                qw = q_white[i]
                Q[b, : qw.shape[0], : qw.shape[1]] = qw
                if cross:
                    rw = r_white[i]
                    R[b, : rw.shape[0], : rw.shape[1]] = rw
                NG[b] = n_refs[i]
            from ..utils.cache import record_shape
            record_shape("grid_refine_knn", batch=chunk, rows=n_pad,
                         ref_rows=m_pad, dpad=dpad, k_sel=k_sel)
            q_dev = jax.device_put(jnp.asarray(Q, dtype), sh3)
            r_dev = q_dev if not cross else jax.device_put(
                jnp.asarray(R, dtype), sh3)
            _, idx = fn(q_dev, r_dev, jax.device_put(jnp.asarray(NG), sh1))
            pending.append((members, idx))
    idx_per_chain: list = [None] * b_true
    for members, idx in pending:
        idx = np.asarray(idx)           # blocks; later chunks keep flowing
        for b, i in enumerate(members):
            idx_per_chain[i] = idx[b, : q_white[i].shape[0]]

    out = np.full((b_true, kmax - 1), np.nan)
    for i, ((s, l, w), sw) in enumerate(zip(norm, q_white)):
        n = s.shape[0]
        rw = r_white[i] if cross else sw
        ke = min(kmax, n_refs[i])
        dknn = guarded_refine_knn_f64(
            sw, rw, idx_per_chain[i], ke,
            self_mode=not cross,
            reselect=lambda ks, _q=sw, _r=rw: sharded_knn_candidates(
                _q, None if not cross else _r, ks, mesh=mesh, dtype=dtype))
        sumw = (float(np.sum(w)) if sum_adjusted_weights is None
                else float(sum_adjusted_weights[i]))
        mle = log_evidence_from_knn_np(
            dknn, l, w, sumw, ndims[i],
            log_jacobian=stats_list[i].log_jacobian,
            log_prior_volume=math.log(prior_volumes[i]),
            k_start=0 if cross else 1, nsamples=n)
        # a tiny reference partition (n_refs[i] < kmax) fills only its
        # first ke-1 columns; the rest stay NaN — same convention as the
        # device path (_device_refine_finalize docstring), instead of a
        # batch-killing broadcast error
        out[i, : len(mle) - 1] = mle[1:]
    return out


# back-compat alias (pre-cross name)
sharded_grid_auto_evidence_refine = sharded_grid_evidence_refine


def make_sharded_grid_device_refine(mesh: Mesh, axes=("dp", "ring"), *,
                                    k_sel: int, kmax: int, engine: str,
                                    cross: bool = False):
    """dp x ring device-resident parity program: a batch of chains
    data-parallel over ``dp``; within each ring group the chain's query
    rows are sharded and the reference set is materialized by a tiled
    ``all_gather`` (no replicated host upload — in auto mode the
    query shards themselves are gathered, in cross mode the sharded-uploaded
    reference partition is).  Each device runs batched selection +
    double-float refinement + partial double-float estimator on its shard;
    the (B_loc, P, 2*kmax+1) partials are all-gathered so only scalars
    leave the mesh — the multi-chip counterpart of
    ``ops.pipeline.fused_refine_dotp_batch``.  Auto mode zeroes the self
    match via the ring row offset; cross mode searches each chain's queries
    in its own reference partition (k0=0 semantics applied by the host).
    """
    dp, ring = axes
    key = ("grid_devref", _mesh_key(mesh), axes, k_sel, kmax, engine, cross)
    fn = _PROGRAM_CACHE.get(key)
    if fn is not None:
        return fn
    from ..ops.pipeline import _refine_dotp_post

    def body(qhi, qlo, rhi_s, rlo_s, scalh, scall, valid, n_ref, ndim,
             inv_s2):
        p_idx = jax.lax.axis_index(ring)
        nq_loc = qhi.shape[1]
        offset = (p_idx * nq_loc).astype(jnp.int32)
        rhi = jax.lax.all_gather(rhi_s, ring, axis=1, tiled=True)
        rlo = jax.lax.all_gather(rlo_s, ring, axis=1, tiled=True)
        # auto mode: no in-kernel diagonal pin — queries are a shard of
        # the replicated reference, so the self candidate wins slot 0
        # naturally at distance 0; the post zeroes it via the offset
        from ..ops.knn import knn_select_batched
        _, idx = knn_select_batched(qhi, rhi, k_sel, self_mode=False,
                                    nr=n_ref, engine=engine)

        def post(qh, ql, rh, rl, sh, sl, v, nd, s2, ib):
            return _refine_dotp_post(qh, ql, rh, rl, sh, sl, v, nd, s2, ib,
                                     offset, kmax=kmax, self_mode=not cross)

        flat = jax.vmap(post)(qhi, qlo, rhi, rlo, scalh, scall, valid,
                              ndim, inv_s2, idx)
        return jax.lax.all_gather(flat, ring, axis=1)   # (B_loc, P, 2k+1)

    if cross:
        wrapped = body
    else:
        def wrapped(qhi, qlo, scalh, scall, valid, n_ref, ndim, inv_s2):
            return body(qhi, qlo, qhi, qlo, scalh, scall, valid, n_ref,
                        ndim, inv_s2)

    ref_specs = (P(dp, ring, None), P(dp, ring, None)) if cross else ()
    sharded = jax.shard_map(
        wrapped, mesh=mesh,
        in_specs=(P(dp, ring, None), P(dp, ring, None), *ref_specs,
                  P(dp, ring), P(dp, ring), P(dp, ring),
                  P(dp), P(dp), P(dp)),
        out_specs=P(dp, None, None),
        check_vma=False)
    fn = jax.jit(sharded)
    _PROGRAM_CACHE[key] = fn
    return fn


def sharded_grid_device_refine_evidence(chains, *, kmax: int = 2,
                                        prior_volumes=None,
                                        sum_adjusted_weights=None,
                                        chains2=None,
                                        pad_candidates: int = 4,
                                        mesh: Optional[Mesh] = None,
                                        engine: str = "auto",
                                        defer: bool = False):
    """Parity-grade batched evidence on a dp x ring mesh with scalars-only
    device->host traffic: host f64 whitening per chain, double-float
    coordinate upload, ONE SPMD program per batch (selection + double-float
    refinement + estimator), f64 host bookkeeping.  The device-resident
    sibling of :func:`sharded_grid_evidence_refine` — for deployments
    where fetching per-row candidate indices dominates.  Auto mode, or cross mode when ``chains2`` is a
    matching sequence of reference-partition sample arrays (combined
    covariance — quirk Q1; k0=0 semantics).  Returns (len(chains), kmax-1)
    at ~1e-13 lnZ parity.

    ``defer=True`` returns a zero-argument finalize callable instead: the
    device program is dispatched immediately but the result fetch (and any
    thin-margin retry) happens when the callable runs — lets a driver
    dispatch many batches back-to-back so uploads pipeline under compute.
    """
    from ..ops.dfloat import df_split_rows
    from ..ops.knn import bucket_size_pow2
    from ..ops.pipeline import _device_refine_finalize
    from ..ops.whiten import apply_whiten, whiten_stats
    from ..utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from ..ops.knn import select_engine
    kmax = max(2, kmax)
    engine = select_engine(engine)
    mesh = _default_grid_mesh(mesh)
    ring_n = mesh.shape["ring"]
    norm = _normalize_chains(chains)
    b_true = len(norm)
    cross = chains2 is not None
    if cross:
        refs = [np.asarray(s2, np.float64) for s2 in chains2]
        if len(refs) != b_true:
            raise ValueError("chains2 must match chains 1:1")
        n_refs = [r.shape[0] for r in refs]
    else:
        refs = None
        n_refs = [s.shape[0] for s, _, _ in norm]
    ndims = [s.shape[1] for s, _, _ in norm]
    dpad = _dpad_class(max(ndims))
    ns = [s.shape[0] for s, _, _ in norm]
    if min(n_refs) <= kmax:
        raise ValueError(f"reference partitions shorter than kmax+1="
                         f"{kmax + 1} rows are not supported by the batched "
                         "device-refine path; use evidence_fn per chain")
    _, b_pad, n_pad, _ = _grid_batch_layout(norm, mesh, pow2_rows=True)
    if cross:
        m_pad = bucket_size_pow2(max(n_refs))
        m_pad = ((m_pad + ring_n - 1) // ring_n) * ring_n
    else:
        m_pad = n_pad
    # cap by the LARGEST reference partition, not the smallest: the batched
    # selection masks per-chain absent candidates (rows >= the chain's true
    # count come back idx=-1/+inf and are excluded downstream), so a small
    # chain in the batch must not starve the large chains of candidates —
    # nor disable their thin-margin retry (round-4 review finding)
    k_sel = min(kmax + pad_candidates, max(n_refs))
    if prior_volumes is None:
        prior_volumes = np.ones(b_true)

    # pooled host staging (ops.pipeline._pooled): first-touch page faults
    # are far slower than re-zeroing already-faulted pages — with one
    # ~2.5 MB staging set per chunk and ~175 chunks per grid run, fresh
    # np.zeros cost seconds of host time.
    # Buffers are re-zeroed wholesale so semantics match fresh allocation.
    from ..ops.pipeline import _pooled
    QHI = _pooled("grid_qhi", (b_pad, n_pad, dpad), np.float32)
    QLO = _pooled("grid_qlo", (b_pad, n_pad, dpad), np.float32)
    QHI[:] = 0.0
    QLO[:] = 0.0
    if cross:
        RHI = _pooled("grid_rhi", (b_pad, m_pad, dpad), np.float32)
        RLO = _pooled("grid_rlo", (b_pad, m_pad, dpad), np.float32)
        RHI[:] = 0.0
        RLO[:] = 0.0
    SCH = _pooled("grid_sch", (b_pad, n_pad), np.float32)
    SCL = _pooled("grid_scl", (b_pad, n_pad), np.float32)
    VAL = _pooled("grid_val", (b_pad, n_pad), np.float32)
    SCH[:] = 0.0
    SCL[:] = 0.0
    VAL[:] = 0.0
    NG = np.ones(b_pad, np.int32)
    ND = np.ones(b_pad, np.int32)
    IS2 = np.ones(b_pad, np.float32)
    hosts = []
    for i, (s, l, w) in enumerate(norm):
        n, d = s.shape
        if cross:
            stats = whiten_stats(np.concatenate([s, refs[i]]))
            sw = apply_whiten(s, stats)
            rw = apply_whiten(refs[i], stats)
            # common re-centre on the reference set (selection precision)
            mu_w = rw.mean(axis=0)
            sw = sw - mu_w
            rw = rw - mu_w
            df_split_rows(rw, RHI[i], RLO[i])
        else:
            stats = whiten_stats(s)
            sw = apply_whiten(s, stats)
            sw, _ = center_f64(sw, None)
        df_split_rows(sw, QHI[i], QLO[i])
        lnl_max = float(np.max(l))
        fs = np.exp(l - lnl_max) / w
        df_split_rows(fs, SCH[i], SCL[i])
        VAL[i, :n] = 1.0
        NG[i] = n_refs[i]
        ND[i] = d
        IS2[i] = np.float32(n_refs[i] ** (2.0 / d) / d)
        hosts.append(dict(n=n, ndim=d, lnl_max=lnl_max, cross=cross,
                          log_j=stats.log_jacobian, sum_w=float(np.sum(w)),
                          inv_s2=float(IS2[i]), k_sel=k_sel,
                          kmax_eff=kmax, engine=engine))
    for i in range(b_true, b_pad):
        VAL[i, 0] = 1.0     # one fake valid row keeps pad-chain sums finite

    from ..utils.cache import record_shape
    record_shape("grid_device_refine", batch=b_pad, rows=n_pad,
                 ref_rows=m_pad, dpad=dpad, k_sel=k_sel, kmax=kmax,
                 cross=cross, engine=engine)
    fn = make_sharded_grid_device_refine(mesh, ("dp", "ring"), k_sel=k_sel,
                                         kmax=kmax, engine=engine,
                                         cross=cross)
    sh3 = NamedSharding(mesh, P("dp", "ring", None))
    sh2 = NamedSharding(mesh, P("dp", "ring"))
    sh1 = NamedSharding(mesh, P("dp"))
    # pooled buffers are REUSED by the next (possibly deferred) chunk, so
    # the device arrays must not alias them (copy=True defeats the CPU
    # backend's zero-copy) NOR be mid-transfer when the next chunk re-zeros
    # them (block_until_ready waits for the copies)
    def _stage(x, sharding):
        return jax.device_put(jnp.array(x, copy=True), sharding)
    args = jax.block_until_ready((
        _stage(QHI, sh3), _stage(QLO, sh3),
        *((_stage(RHI, sh3), _stage(RLO, sh3)) if cross else ()),
        _stage(SCH, sh2), _stage(SCL, sh2), _stage(VAL, sh2),
        jax.device_put(jnp.asarray(NG), sh1),
        jax.device_put(jnp.asarray(ND), sh1),
        jax.device_put(jnp.asarray(IS2), sh1)))
    parts_dev = fn(*args)

    def _finalize() -> np.ndarray:
        parts = np.asarray(parts_dev, np.float64)

        thin_true = parts[:b_true, :, -1].sum()
        if thin_true > 0:
            # retry only if more padding would actually widen the candidate
            # set (k_sel is capped by the smallest reference partition)
            retry_pad = 4 * pad_candidates + 8
            if (pad_candidates < 32
                    and min(kmax + retry_pad, max(n_refs)) > k_sel):
                logger.info("grid device-refine: thin margins on %d rows; "
                            "re-running with %d extra candidates",
                            int(thin_true), retry_pad)
                return sharded_grid_device_refine_evidence(
                    chains, kmax=kmax, prior_volumes=prior_volumes,
                    sum_adjusted_weights=sum_adjusted_weights,
                    chains2=chains2,
                    pad_candidates=retry_pad, mesh=mesh, engine=engine)
            logger.warning(
                "grid device-refine: %d rows had thin candidate margins "
                "(near-tied neighbour distances) and the candidate set "
                "cannot be widened further; use sharded_grid_evidence_"
                "refine if exact tie ordering matters", int(thin_true))

        out = np.zeros((b_true, kmax - 1))
        for i in range(b_true):
            # exact f64 combine of the per-device double-float partials
            vals = (parts[i, :, :kmax].sum(axis=0)
                    + parts[i, :, kmax:2 * kmax].sum(axis=0))
            sw_i = (None if sum_adjusted_weights is None
                    else float(sum_adjusted_weights[i]))
            if not np.all(np.isfinite(vals)):
                # double-float overflow on this chain (far outliers / high
                # ndim): the log-space host path has unlimited range
                from ..ops.pipeline import host_refine_evidence
                logger.warning("grid device-refine: double-float overflow "
                               "on chain %d; host-refine fallback", i)
                s, l, w = norm[i]
                out[i] = host_refine_evidence(
                    s, l, w, samples2=refs[i] if cross else None, kmax=kmax,
                    prior_volume=float(prior_volumes[i]),
                    sum_adjusted_weights=sw_i, engine=engine)
                continue
            flat = np.concatenate([vals, np.zeros(kmax), [0.0]])
            out[i] = _device_refine_finalize(flat, hosts[i], kmax,
                                             float(prior_volumes[i]), sw_i,
                                             warn_thin=False)
        return out

    if defer:
        return _finalize
    return _finalize()

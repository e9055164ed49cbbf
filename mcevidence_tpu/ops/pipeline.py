"""Fused single-jit evidence pipelines.

Two device-resident paths share this module (same estimator semantics as
the reference, MCEvidence.py:950-1168; sample counts padded to compile
buckets with true counts as runtime scalars — one compile per bucket):

* ``fused_auto_evidence`` — the all-f32 "fast" mode: masked-moment
  whitening -> kNN selection -> log-space estimator in one jit (~1e-3
  in ln Z).
* ``fused_refine_dotp`` / ``device_refine_evidence`` — the "device"
  parity mode: host f64 whitening, double-float (f32-pair) candidate
  refinement AND estimator on device, scalars-only device->host traffic
  (~1e-13 in ln Z).  See the section comment below for the precision
  engineering.
"""

from __future__ import annotations

import functools
import logging
import math
import threading
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from .knn import bucket_size

logger = logging.getLogger(__name__)


@functools.partial(jax.jit, static_argnames=("kmax", "ndim", "engine"))
def fused_auto_evidence(samples, lnlike, weights, valid, n_true,
                        log_prior_volume, *, kmax: int, ndim: int,
                        engine: str = "xla"):
    """Jitted auto-evidence on padded arrays.

    Args:
      samples: (Np, ndim) f32, padded rows zero.
      lnlike:  (Np,) f32, padded rows very negative (contribute exp -> 0).
      weights: (Np,) f32, padded rows 1 (only divide; masked elsewhere).
      valid:   (Np,) f32 0/1 mask.
      n_true:  runtime scalar — true sample count.
      log_prior_volume: runtime scalar.
      engine:  resolved kNN engine (``knn.select_engine``).

    Returns (kmax,) MLE row (column 0 unused — quirk Q2 layout).
    """
    from .knn import knn_select
    from .whiten import whiten_masked_jnp
    white, log_j, _ = whiten_masked_jnp(samples, valid)
    d2, _ = knn_select(white, white, kmax, self_mode=True, nr=n_true,
                       engine=engine)

    from .estimator import log_evidence_from_knn
    mle = log_evidence_from_knn(
        d2, lnlike, weights, jnp.sum(weights * valid), ndim,
        log_jacobian=log_j, log_prior_volume=log_prior_volume,
        k_start=1, nsamples=n_true, valid=valid, squared=True)
    # columns k >= n_true have no k-th neighbour (selection returns +inf
    # distance, which would propagate log(inf)=+inf into the result): mark
    # them undefined, matching the host parity path's NaN padding
    k_idx = jnp.arange(kmax)
    return jnp.where(k_idx < n_true, mle, jnp.nan)


# ---------------------------------------------------------------------------
# device-resident parity path ("device" precision): f32 selection + double-
# float refinement + double-float estimator, ALL on device — only (kmax, 2)
# scalars cross the device->host link, instead of the host-refine path's
# (N, k_sel) candidate indices.
# Accuracy: ~1e-13 in ln Z — the device program uses NO transcendentals
# (exp/log scalars are precomputed on the host in f64, see
# _fused_refine_dotp_impl); the host-refine path stays the 1e-14 reference.
# ---------------------------------------------------------------------------

MAX_HALF_POW = 8        # double-float z^(d/2) ladder depth (ndim <= 17);
                        # the dpad layout classes cap the device paths at
                        # DEVICE_NDIM_MAX — larger chains take host refine

# widest coordinate-padding class of the device-resident programs
# (ring.GRID_DPAD_CLASSES); chains with more parameters fall back to the
# host-refine parity path instead of crashing on an internal constant
DEVICE_NDIM_MAX = 16

# share of the device's allocatable memory (memory_stats()["bytes_limit"])
# one device-refine dispatch may plan for; the rest is headroom for the
# compiled program, XLA scratch and arrays other callers keep resident
DEVICE_MEMORY_SHARE = 0.75

# live (rows, k_sel, dpad)-shaped f32 temporaries in the double-float
# refinement: candidate_d2_df gathers rhi[idx]/rlo[idx] and runs the
# error-free two_diff/two_prod chains on them — the gathers are
# materialized and several EFT intermediates stay live before the dpad
# reduction.  8 is deliberately conservative (headroom beats a mid-run
# out-of-memory error).
_REFINE_TEMP_BUFFERS = 8

# reference rows per knn_select_xla scan step (its default block_size)
_XLA_SELECT_BLOCK = 2048


def device_memory_budget_bytes(device=None) -> int:
    """Bytes one device-refine dispatch may plan for: DEVICE_MEMORY_SHARE of
    what the allocator may hand out.  ``None`` when the device does not
    report it (the CPU backend): no plan is enforced there."""
    device = jax.devices()[0] if device is None else device
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    return None if not limit else int(limit * DEVICE_MEMORY_SHARE)


def estimate_device_refine_hbm_bytes(n: int, n_ref: int, ndim: int,
                                     k_sel: int, cross: bool = False,
                                     engine: str = "xla") -> int:
    """Shape-math device-memory plan for ONE device-refine dispatch.

    Everything the program keeps live, in padded shapes (pow-2 row buckets,
    dpad coordinate class): the double-float coordinate arrays, the
    (rows, k_sel, dpad) refinement temporaries, the selection output, and —
    on the ``xla`` engine — the (rows, block) f32 distance tile each scan
    step writes (the Triton kernel keeps its tiles in registers).

    ``cross`` must mirror the dispatch (``samples2 is not None``):
    _device_refine_prepare allocates separate rhi/rlo whenever a second
    chain is given, INCLUDING when the two chains happen to have equal row
    counts (the even-N ``--cross`` split, matched-size two-chain runs) —
    a count comparison is not a valid proxy."""
    from ..parallel.ring import _dpad_class
    from .knn import _kernel_takes, bucket_size_pow2
    nb = bucket_size_pow2(n)
    mb = bucket_size_pow2(n_ref)
    dpad = _dpad_class(ndim)
    coords = 4 * (nb + (mb if cross else 0)) * dpad * 4   # qhi/qlo/rhi/rlo
    temps = _REFINE_TEMP_BUFFERS * nb * k_sel * dpad * 4
    select_out = 2 * nb * k_sel * 4                           # d2 + idx
    vectors = 4 * nb * 4                                      # scal/valid/...
    tile = (0 if _kernel_takes(engine, k_sel)
            else nb * min(_XLA_SELECT_BLOCK, mb) * 4)
    return coords + temps + select_out + vectors + tile


def fused_refine_dotp(qhi, qlo, rhi, rlo, scalh, scall, valid, n_ref_true,
                      ndim, inv_s2, *, k_sel: int, kmax: int,
                      engine: str = "xla", self_mode: bool = True):
    """Device-refine program for one cell (row_offset=0: query row i is
    reference row i in self mode), run as TWO programs: the selection
    compiles normally, the double-float refinement/estimator compiles at
    backend optimization level 0.  Optimizing compilers rematerialize
    products into consumer fusions and contract them into fmas there,
    silently destroying the error-free-transformation identities
    (~2^-24-relative corruption of the k=1 column on XLA:CPU; dfloat's
    COMPILER CAVEAT documents the investigation — neither optimization
    barriers nor bit-level pins survive the pipeline).  The post stage is
    O(N*k), so O0 costs microseconds."""
    _, idx = _select_jit(qhi, rhi, k_sel, self_mode, engine, n_ref_true)
    return _refine_dotp_post_o0(qhi, qlo, rhi, rlo, scalh, scall, valid,
                                ndim, inv_s2, idx, jnp.int32(0),
                                kmax=kmax, self_mode=self_mode)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _select_jit(qhi, rhi, k_sel, self_mode, engine, n_ref_true):
    """Candidate selection of the two-program device-refine path."""
    from .knn import knn_select
    return knn_select(qhi, rhi, k_sel, self_mode=self_mode, nr=n_ref_true,
                      engine=engine)


_O0_POST_CACHE: dict = {}


def _refine_dotp_post_o0(qhi, qlo, rhi, rlo, scalh, scall, valid, ndim,
                         inv_s2, idx, row_offset, *, kmax: int,
                         self_mode: bool):
    """AOT-compiled _refine_dotp_post at xla_backend_optimization_level=0:
    the only reliable way (found) to keep an optimizing backend from
    contracting the error-free double-float identities.  Cached per
    (shapes, statics)."""
    args = (qhi, qlo, rhi, rlo, scalh, scall, valid, ndim, inv_s2, idx,
            row_offset)
    key = (tuple((a.shape, str(a.dtype)) for a in args), kmax, self_mode)
    fn = _O0_POST_CACHE.get(key)
    if fn is None:
        fn = jax.jit(functools.partial(
            _refine_dotp_post, kmax=kmax, self_mode=self_mode)
        ).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": "0"})
        _O0_POST_CACHE[key] = fn
    return fn(*args)


def fused_refine_dotp_batch(qhi, qlo, rhi, rlo, scalh, scall, valid,
                            n_ref_true, ndim, inv_s2, *, k_sel: int,
                            kmax: int, engine: str = "xla",
                            self_mode: bool = True):
    """Batched device-refine program: a (B, ...) batch of same-bucket cells
    in ONE dispatch+fetch round trip.  Selection runs batched (per-member
    runtime counts in ``n_ref_true``); the double-float refinement and
    estimator vmap, compiled at O0 like :func:`fused_refine_dotp`.
    Returns (B, 2*kmax+1)."""
    _, idx = _select_batch_jit(qhi, rhi, k_sel, self_mode, engine,
                               n_ref_true)
    args = (qhi, qlo, rhi, rlo, scalh, scall, valid, ndim, inv_s2, idx)
    key = ("batch", tuple((a.shape, str(a.dtype)) for a in args), kmax,
           self_mode)
    fn = _O0_POST_CACHE.get(key)
    if fn is None:
        def post(qh, ql, rh, rl, sh, sl, v, nd, s2, idx_b):
            return _refine_dotp_post(qh, ql, rh, rl, sh, sl, v, nd, s2,
                                     idx_b, jnp.int32(0), kmax=kmax,
                                     self_mode=self_mode)
        fn = jax.jit(jax.vmap(post)).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": "0"})
        _O0_POST_CACHE[key] = fn
    return fn(*args)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _select_batch_jit(qhi, rhi, k_sel, self_mode, engine, n_ref_true):
    """Batched candidate selection of :func:`fused_refine_dotp_batch`."""
    from .knn import knn_select_batched
    return knn_select_batched(qhi, rhi, k_sel, self_mode=self_mode,
                              nr=n_ref_true, engine=engine)


def _fused_refine_dotp_impl(qhi, qlo, rhi, rlo, scalh, scall, valid,
                            n_ref_true, ndim, inv_s2, row_offset, *,
                            k_sel: int, kmax: int, engine: str = "xla",
                            self_mode: bool = True,
                            kernel_self_pin: bool = True):
    """Device core in ONE program (the sharded programs' body): returns
    flat [dotp_hi (kmax), dotp_lo (kmax), thin] with
    dotp_k = sum_j (d2_jk * inv_s2)^(ndim/2) * scal_j  and a thin-margin
    count for the candidate-sufficiency guard.

    Auto mode (``self_mode=True``): pass rhi/rlo = qhi/qlo; the self match
    occupies column 0 with distance exactly 0.  Cross mode: NNs of q rows
    searched among r rows (k0=0 semantics — the host applies the
    (S*(k+1)+1) denominators).

    ``scal`` = exp(lnL - lnL_max) / w as a double-float pair, PRECOMPUTED
    on the host in f64: f32 transcendentals carry ~1e-7-relative errors,
    so the device program uses no transcendentals at all — only
    error-free double-float +,-,* and a Newton-corrected sqrt.  Host-side
    bookkeeping (all f64): ball-volume constant, SumW, Jacobian, lnL_max,
    prior volume, the denominators and the inv_s2 unscaling — device
    arithmetic only ever sees O(1) magnitudes.  ``ndim`` is a RUNTIME
    scalar (the power loop is statically unrolled to MAX_HALF_POW and
    masked), so one compile serves every dimensionality.
    """
    # kernel_self_pin: the in-kernel diagonal pin assumes query row i IS
    # reference row i (single shard).  Sharded self mode (queries are a
    # shard of the replicated reference set) selects without the pin — the
    # self candidate wins slot 0 naturally at distance ~0 — and relies on
    # the offset-aware zeroing below.
    from .knn import knn_select
    _, idx = knn_select(qhi, rhi, k_sel, self_mode=kernel_self_pin,
                        nr=n_ref_true, engine=engine)
    return _refine_dotp_post(qhi, qlo, rhi, rlo, scalh, scall, valid,
                             ndim, inv_s2, idx, row_offset, kmax=kmax,
                             self_mode=self_mode)


def _refine_dotp_post(qhi, qlo, rhi, rlo, scalh, scall, valid, ndim,
                      inv_s2, idx, row_offset, *, kmax: int,
                      self_mode: bool):
    """Everything after selection: double-float refinement, sufficiency
    statistic, df powers, masked df reduction.  Pure jnp — vmaps cleanly."""
    from .dfloat import (candidate_d2_df, df_mul, df_mul_f32, df_reduce_sum,
                         df_sqrt)

    d2h, d2l = candidate_d2_df(qhi, qlo, rhi, rlo, idx)
    if self_mode:
        row = (row_offset
               + jnp.arange(qhi.shape[0], dtype=jnp.int32)[:, None])
        selfm = idx == row
        d2h = jnp.where(selfm, 0.0, d2h)
        d2l = jnp.where(selfm, 0.0, d2l)
    key = d2h + d2l
    order = jnp.argsort(key, axis=1)
    if idx.shape[1] > kmax:
        # sufficiency guard statistic: rows whose kmax-th refined distance
        # sits within the selection's ranking noise of the worst kept
        # candidate.  These are SQUARED distances, so the margin factor is
        # the square of the host guard's 2^-10 distance margin (knn.py) —
        # (1-2^-10)^2 ~= 1-2^-9 — keeping both guards equally sensitive.
        kth = jnp.take_along_axis(key, order[:, kmax - 1:kmax],
                                  axis=1)[:, 0]
        last = jnp.take_along_axis(key, order[:, -1:], axis=1)[:, 0]
        thin = ((kth > last * (1.0 - 2.0 ** -9)) & jnp.isfinite(last)
                & (last > 0) & (valid > 0))
        thin_count = jnp.sum(thin.astype(jnp.float32))
    else:
        # k_sel == kmax: kth IS the boundary — the statistic would be
        # vacuously true for every valid row and trigger pointless retries
        thin_count = jnp.float32(0.0)

    order = order[:, :kmax]
    d2h = jnp.take_along_axis(d2h, order, axis=1)
    d2l = jnp.take_along_axis(d2l, order, axis=1)
    zh, zl = df_mul_f32(d2h, d2l, inv_s2)

    half = ndim // 2
    odd = ndim - 2 * half
    ph = jnp.ones_like(zh)
    pl = jnp.zeros_like(zh)
    for i in range(MAX_HALF_POW):
        nh, nl = df_mul(ph, pl, zh, zl)
        take = i < half
        ph = jnp.where(take, nh, ph)
        pl = jnp.where(take, nl, pl)
    sqh, sql = df_sqrt(zh, zl)
    nh, nl = df_mul(ph, pl, sqh, sql)
    ph = jnp.where(odd == 1, nh, ph)
    pl = jnp.where(odd == 1, nl, pl)

    th, tl = df_mul(ph, pl, scalh[:, None], scall[:, None])
    mask = (valid[:, None] > 0) & jnp.isfinite(zh)
    th = jnp.where(mask, th, 0.0)
    tl = jnp.where(mask, tl, 0.0)
    dh, dl = df_reduce_sum(th, tl, axis=0)                # (kmax,)
    # one flat result array [dh.., dl.., thin]: everything comes back in
    # ONE device->host fetch
    return jnp.concatenate([dh, dl, thin_count[None]])


# Reusable host staging buffers: first-touch page faults make fresh
# per-cell numpy allocations a large share of the host prep, while writes
# to already-faulted pages run at memory speed.  A buffer is refilled only
# after the arrays staged from it are ready on the device: the
# host-to-device copy may still read the host buffer after jnp.array
# returns, and the next cell's prep would overwrite it mid-copy.  Keyed by
# (name, thread, shape, dtype); sizes are bucketed, so the pool stays small.
_HOST_BUFFERS: dict = {}


def _pooled(name, shape, dtype):
    # thread id in the key: concurrent preparers (mcevidence-serve --workers
    # N) must never share a staging buffer — one thread's fill would clobber
    # another's between fill and dispatch.  Pool size stays bounded by
    # (shapes x worker threads).
    key = (name, threading.get_ident(), tuple(np.atleast_1d(shape)),
           np.dtype(dtype).str)
    buf = _HOST_BUFFERS.get(key)
    if buf is None:
        buf = np.zeros(shape, dtype)
        _HOST_BUFFERS[key] = buf
    return buf


def _device_refine_prepare(samples, lnlike, weights, kmax, pad_candidates,
                           engine, samples2=None):
    """Host prep for the device-resident path; returns (device args dict,
    host constants dict).  ``samples2`` switches to cross mode (NNs of
    samples searched in samples2; combined covariance — quirk Q1)."""
    from ..parallel.ring import _dpad_class
    from .dfloat import df_split_rows
    from .knn import bucket_size_pow2
    cross = samples2 is not None
    n, ndim = samples.shape
    from .knn import select_engine
    engine = select_engine(engine)
    s1 = np.asarray(samples, np.float64)

    # Whitening + centring fused into ONE rotation of pre-centred samples:
    # (s - mu) @ (eigvecs/sqrt(ev)) is exactly the whitened-then-centred
    # result (linearity), the centred GEMM gives the covariance without
    # np.cov's internal copies, and centring before the f32 split preserves
    # the selection ranking precision for strongly offset chains (the f32
    # hi half of an uncentred coordinate loses |offset|*2^-24 per coord).
    def _stats_and_rot(x, xc):
        # warn-and-skip policy lives in whiten_stats (ONE home, host side);
        # the centred GEMM here skips np.cov's internal copies
        from .whiten import whiten_stats
        cov = (xc.T @ xc) / max(x.shape[0] - 1.0, 1.0)
        st = whiten_stats(x, cov=cov)
        if not st.posdef:
            return 0.0, None
        return st.log_jacobian, st.eigvecs / np.sqrt(st.eigvals)

    if cross:
        s2 = np.asarray(samples2, np.float64)
        allx = np.concatenate([s1, s2])
        mu = allx.mean(axis=0)
        allc = allx - mu
        log_j, rot = _stats_and_rot(allx, allc)
        if rot is None:
            sw, rw = s1 - mu, s2 - mu
        else:
            sw = allc[:n] @ rot
            rw = allc[n:] @ rot
            # common re-centre on the reference set (selection precision)
            mu_w = rw.mean(axis=0)
            sw -= mu_w
            rw -= mu_w
    else:
        nb0 = bucket_size_pow2(n)
        mu = s1.mean(axis=0)
        # pooled f64 scratch (bucketed shapes keep the pool small)
        s1c = _pooled("centered", (nb0, ndim), np.float64)[:n]
        np.subtract(s1, mu, out=s1c)
        log_j, rot = _stats_and_rot(s1, s1c)
        if rot is None:
            sw = s1c
        else:
            sw = _pooled("whitened", (nb0, ndim), np.float64)[:n]
            np.dot(s1c, rot, out=sw)
    lnl = np.asarray(lnlike, np.float64)
    lnl_max = float(np.max(lnl))
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)

    # coarse power-of-2 buckets: the program's compute is cheap, so fewer
    # distinct compiled shapes beats tighter padding (each shape is a
    # compile per cold process)
    nb = bucket_size_pow2(n)
    dpad = _dpad_class(ndim)
    n_ref = s2.shape[0] if cross else n
    qhi = _pooled("qhi", (nb, dpad), np.float32)
    qlo = _pooled("qlo", (nb, dpad), np.float32)
    qhi[n:] = 0.0
    qlo[n:] = 0.0
    if ndim < dpad:
        qhi[:n, ndim:] = 0.0
        qlo[:n, ndim:] = 0.0
    df_split_rows(sw, qhi, qlo)
    if cross:
        mb = bucket_size_pow2(n_ref)
        rhi = _pooled("rhi", (mb, dpad), np.float32)
        rlo = _pooled("rlo", (mb, dpad), np.float32)
        rhi[n_ref:] = 0.0
        rlo[n_ref:] = 0.0
        if ndim < dpad:
            rhi[:n_ref, ndim:] = 0.0
            rlo[:n_ref, ndim:] = 0.0
        df_split_rows(rw, rhi, rlo)
    # exp(fs)/w in f64 on the HOST: the device program uses no f32
    # transcendentals, so the scale factors ship as double-float data
    fs = _pooled("fs", (nb,), np.float64)[:n]
    np.subtract(lnl, lnl_max, out=fs)
    np.exp(fs, out=fs)
    np.divide(fs, w, out=fs)
    scalh = _pooled("scalh", (nb,), np.float32)
    scall = _pooled("scall", (nb,), np.float32)
    scalh[n:] = 0.0
    scall[n:] = 0.0
    df_split_rows(fs, scalh, scall)
    valid = _pooled("valid", (nb,), np.float32)
    valid[:n] = 1.0
    valid[n:] = 0.0
    inv_s2 = np.float32(n_ref ** (2.0 / ndim) / ndim)
    k_sel = min(kmax + pad_candidates, n_ref)
    kmax_eff = min(kmax, k_sel)     # tiny reference partitions: n_ref < kmax
    from ..utils.cache import record_shape
    record_shape("device_refine", rows=nb, dpad=dpad, k_sel=k_sel,
                 kmax=kmax_eff, cross=cross, engine=engine)
    # copy=True: on the CPU backend jnp.asarray ALIASES the numpy buffer
    # (zero-copy), which would let the next prep overwrite a pooled buffer
    # still referenced by an in-flight dispatch; on an accelerator the copy
    # is the host-to-device transfer that happens anyway
    dev = dict(qhi=jnp.array(qhi, copy=True), qlo=jnp.array(qlo, copy=True),
               scalh=jnp.array(scalh, copy=True),
               scall=jnp.array(scall, copy=True),
               valid=jnp.array(valid, copy=True),
               n_true=jnp.asarray(n_ref, jnp.int32),
               ndim=jnp.asarray(ndim, jnp.int32),
               inv_s2=jnp.asarray(inv_s2))
    if cross:
        dev["rhi"] = jnp.array(rhi, copy=True)
        dev["rlo"] = jnp.array(rlo, copy=True)
    else:
        dev["rhi"] = dev["qhi"]
        dev["rlo"] = dev["qlo"]
    jax.block_until_ready(dev)      # the pooled buffers may be refilled now
    host = dict(n=n, ndim=ndim, lnl_max=lnl_max, cross=cross,
                log_j=log_j, sum_w=float(np.sum(w)),
                inv_s2=float(inv_s2), k_sel=k_sel, kmax_eff=kmax_eff,
                engine=engine)
    return dev, host


def _device_refine_finalize(flat, host, kmax, prior_volume,
                            sum_adjusted_weights, warn_thin=True):
    """f64 host bookkeeping around the fetched flat device result
    [dotp_hi (kmax_eff), dotp_lo (kmax_eff), thin_count].  Columns beyond
    kmax_eff (tiny reference partitions) come back NaN."""
    from .estimator import log_ball_volume_const
    flat = np.asarray(flat, np.float64)
    thin_count = flat[-1]
    ke = host.get("kmax_eff", kmax)
    n, ndim = host["n"], host["ndim"]
    sumw = (host["sum_w"] if sum_adjusted_weights is None
            else float(sum_adjusted_weights))
    log_c = log_ball_volume_const(ndim)
    vals = flat[:ke] + flat[ke:2 * ke]
    k_idx = np.arange(ke)
    # auto: column 0 is the self match (zeroed); cross: k0=0 semantics —
    # genuine NNs with k_nn = k+1 (reference MCEvidence.py:1120-1123);
    # the caller slices [1:] either way (quirk Q2)
    k_nn = k_idx + 1 if host.get("cross") else k_idx
    with np.errstate(divide="ignore"):
        log_dotp = (np.log(vals) - 0.5 * ndim * math.log(host["inv_s2"])
                    + log_c)
        log_amax = log_dotp - np.log(n * k_nn + 1.0)
    mle = np.full(kmax, np.nan)
    mle[:ke] = (math.log(sumw) + log_amax + host["log_j"] + host["lnl_max"]
                - math.log(prior_volume))
    if warn_thin and float(thin_count) > 0:
        logger.warning(
            "device-refine: %d rows had thin candidate margins (near-tied "
            "neighbour distances); increase pad_candidates or use "
            "precision='refine' if exact tie ordering matters",
            int(float(thin_count)))
    return mle[1:]


def host_refine_evidence(samples, lnlike, weights=None, *, samples2=None,
                         kmax: int = 2, prior_volume: float = 1.0,
                         sum_adjusted_weights=None,
                         engine: str = "auto") -> np.ndarray:
    """Host-refine path as a standalone call (whiten -> exact_knn refine ->
    f64 log-space estimator) — the overflow-proof fallback the device paths
    route to when the double-float estimator leaves f32 dynamic range."""
    from .estimator import log_evidence_from_knn_np
    from .knn import exact_knn
    from .whiten import apply_whiten, whiten_stats
    kmax = max(2, kmax)
    samples = np.asarray(samples, np.float64)
    lnlike = np.asarray(lnlike, np.float64)
    n, ndim = samples.shape
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    cross = samples2 is not None
    allx = np.concatenate([samples, samples2]) if cross else samples
    stats = whiten_stats(allx)
    s1w = apply_whiten(samples, stats)
    s2w = apply_whiten(np.asarray(samples2, np.float64), stats) \
        if cross else None
    dknn = exact_knn(s1w, s2w, kmax, refine=True, engine=engine)
    sumw = (float(np.sum(w)) if sum_adjusted_weights is None
            else float(sum_adjusted_weights))
    mle = log_evidence_from_knn_np(
        dknn, lnlike, w, sumw, ndim, log_jacobian=stats.log_jacobian,
        log_prior_volume=math.log(prior_volume),
        k_start=0 if cross else 1, nsamples=n)
    # tiny reference partitions fill only their defined columns; NaN-pad to
    # the kmax-1 contract so the device-path fallbacks that route here
    # never change their caller's row shape mid-flight
    out = np.full(kmax - 1, np.nan)
    out[: len(mle) - 1] = mle[1:]
    return out


def device_refine_evidence(samples: np.ndarray, lnlike: np.ndarray,
                           weights: Optional[np.ndarray] = None, *,
                           samples2: Optional[np.ndarray] = None,
                           kmax: int = 2, prior_volume: float = 1.0,
                           sum_adjusted_weights: Optional[float] = None,
                           pad_candidates: int = 4,
                           engine: str = "auto",
                           _retried: bool = False) -> np.ndarray:
    """Parity-grade evidence with scalar-only device->host traffic.

    Host f64 whitening -> double-float coordinate upload -> ONE device
    program (packed selection + double-float refinement + double-float
    estimator) -> (2*kmax+1,) fetch -> f64 host bookkeeping.  ~1e-13 lnZ
    parity; returns k = 1..kmax-1 like ``evidence_fn``.  Cross mode when
    ``samples2`` is given (NNs of ``samples`` searched in ``samples2``).
    """
    kmax = max(2, kmax)
    if samples.shape[1] > DEVICE_NDIM_MAX:
        # the device-resident dpad layout classes stop at DEVICE_NDIM_MAX
        # parameters; degrade like every other unsupported device config
        logger.info("device-refine: ndim %d > %d (device layout limit); "
                    "falling back to the host refine path",
                    samples.shape[1], DEVICE_NDIM_MAX)
        return host_refine_evidence(
            samples, lnlike, weights, samples2=samples2, kmax=kmax,
            prior_volume=prior_volume,
            sum_adjusted_weights=sum_adjusted_weights, engine=engine)
    n_ref_guard = (samples2 if samples2 is not None else samples).shape[0]
    k_sel_guard = min(kmax + pad_candidates, n_ref_guard)
    from .knn import select_engine
    est = estimate_device_refine_hbm_bytes(
        samples.shape[0], n_ref_guard, samples.shape[1], k_sel_guard,
        cross=samples2 is not None, engine=select_engine(engine))
    budget = device_memory_budget_bytes()
    if budget is not None and est > budget:
        # the single-device N ceiling: the program's temporaries won't fit
        # device memory — degrade to the host-refine path (candidates
        # refine in host RAM) instead of dying in a mid-run XLA OOM
        logger.warning(
            "device-refine: planned device memory %.1f GiB (N=%d, "
            "k_sel=%d) exceeds the %.1f GiB budget; falling back to the "
            "host refine path", est / 2 ** 30, samples.shape[0],
            k_sel_guard, budget / 2 ** 30)
        return host_refine_evidence(
            samples, lnlike, weights, samples2=samples2, kmax=kmax,
            prior_volume=prior_volume,
            sum_adjusted_weights=sum_adjusted_weights, engine=engine)
    dev, host = _device_refine_prepare(samples, lnlike, weights, kmax,
                                       pad_candidates, engine,
                                       samples2=samples2)
    flat = fused_refine_dotp(
        dev["qhi"], dev["qlo"], dev["rhi"], dev["rlo"],
        dev["scalh"], dev["scall"],
        dev["valid"], dev["n_true"], dev["ndim"], dev["inv_s2"],
        k_sel=host["k_sel"], kmax=host["kmax_eff"], engine=host["engine"],
        self_mode=samples2 is None)
    flat_np = np.asarray(flat)
    n_ref = samples2.shape[0] if samples2 is not None else samples.shape[0]
    if not np.all(np.isfinite(flat_np[:2 * host["kmax_eff"]])):
        # double-float overflow (z^(ndim/2) left f32 range — far outlier
        # rows / high ndim): the log-space host path has unlimited range
        logger.warning("device-refine: double-float overflow; falling back "
                       "to the host refine path")
        return host_refine_evidence(
            samples, lnlike, weights, samples2=samples2, kmax=kmax,
            prior_volume=prior_volume,
            sum_adjusted_weights=sum_adjusted_weights, engine=engine)
    # thin-margin guard: moot when every reference row is already a
    # candidate (k_sel == n_ref => the selection is trivially sufficient)
    if flat_np[-1] > 0 and host["k_sel"] < n_ref:
        retry_pad = 4 * pad_candidates + 8
        if (not _retried
                and min(kmax + retry_pad, n_ref) > host["k_sel"]):
            # thin candidate margins: one retry with 4x padding (same
            # policy as exact_knn's sufficiency guard)
            logger.info("device-refine: thin margins on %d rows; re-running "
                        "with %d extra candidates", int(flat_np[-1]),
                        retry_pad)
            return device_refine_evidence(
                samples, lnlike, weights, samples2=samples2, kmax=kmax,
                prior_volume=prior_volume,
                sum_adjusted_weights=sum_adjusted_weights,
                pad_candidates=retry_pad, engine=engine, _retried=True)
        return _device_refine_finalize(flat_np, host, kmax, prior_volume,
                                       sum_adjusted_weights, warn_thin=True)
    return _device_refine_finalize(flat_np, host, kmax, prior_volume,
                                   sum_adjusted_weights, warn_thin=False)


def device_refine_auto_evidence(samples, lnlike, weights=None, **kw):
    """Back-compat alias for the auto-mode device path."""
    return device_refine_evidence(samples, lnlike, weights, **kw)


def fast_auto_evidence(samples: np.ndarray, lnlike: np.ndarray,
                       weights: Optional[np.ndarray] = None, *,
                       kmax: int = 5, prior_volume: float = 1.0,
                       sum_adjusted_weights: Optional[float] = None,
                       engine: str = "auto") -> np.ndarray:
    """Host wrapper: bucket-pad, run the fused program, return k=1..kmax-1.

    ``sum_adjusted_weights``: importance-adjusted SumW override (quirk Q7);
    applied as a log-shift since only SumW differs from sum(weights).
    """
    kmax = max(2, kmax)
    n, ndim = samples.shape
    if weights is None:
        weights = np.ones(n)
    from .knn import select_engine
    engine = select_engine(engine)
    nb = bucket_size(n)
    from ..utils.cache import record_shape
    record_shape("fast_auto", rows=nb, ndim=ndim, kmax=kmax, engine=engine)
    s = np.zeros((nb, ndim), np.float32)
    # centre in f64 BEFORE the f32 cast: an uncentred coordinate loses
    # |mean|*2^-24 absolute per element (fatal to selection ranking for
    # strongly offset chains), and the uncentred-moment covariance inside
    # the jit cancels catastrophically at large |mean|/std.  Distances,
    # covariance, and Jacobian are all translation-invariant.
    s[:n] = samples - np.asarray(samples, np.float64).mean(axis=0)
    lnl = np.full(nb, -1e30, np.float32)
    lnl[:n] = lnlike
    w = np.ones(nb, np.float32)
    w[:n] = weights
    valid = np.zeros(nb, np.float32)
    valid[:n] = 1.0
    mle = fused_auto_evidence(
        jnp.asarray(s), jnp.asarray(lnl), jnp.asarray(w), jnp.asarray(valid),
        jnp.asarray(n, jnp.int32), jnp.asarray(np.log(prior_volume),
                                               jnp.float32),
        kmax=kmax, ndim=ndim, engine=engine)
    mle = np.asarray(mle, np.float64)
    if sum_adjusted_weights is not None:
        mle = mle + (np.log(sum_adjusted_weights)
                     - np.log(float(np.sum(weights))))
    # column 0 (the auto-mode self-match) is dropped per quirk Q2
    return mle[1:]

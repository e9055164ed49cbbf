"""Double-float (pair-of-f32) arithmetic for device-resident refinement.

The parity-critical part of the evidence pipeline — recomputing the
selected candidates' distances exactly — only needs f64-grade PRECISION on
a tiny O(N k d) workload.  Representing each whitened coordinate as an
unevaluated f32 pair (hi + lo, the classic double-float / Dekker
representation: hi = f32(x), lo = f32(x - hi)) gives ~2^-48 relative
precision using nothing but f32 ops, so the refinement runs on device and
only scalars cross the device->host link.

References: Dekker (1971); Hida, Li & Bailey's QD library error-free
transformation identities.  All helpers are jnp-traceable and shape-
preserving; they rely only on IEEE f32 +,-,* being correctly rounded.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# low-12-stored-mantissa-bits mask for the exact bit split (see _split)
_LO12_MASK = -4096            # int32 ~0xFFF; python int: no device array
                              # at import time (backend-init hygiene)


# COMPILER CAVEAT (round-4 k=1 parity investigation): these identities
# assume every term is a ROUNDED f32 value.  XLA:CPU rematerializes
# producers inside consumer fusions and LLVM contracts mul+add pairs into
# fmas there, so a product flowing into ``s = a + b`` can become
# ``s = fma(x, y, b)`` in one fusion while a sibling fusion uses the
# rounded product — breaking the error identity (~2^-24-relative
# corruption, observed as device-mode k=1 lnZ degrading to ~1e-9).
# In-graph defenses do NOT survive the pipeline (lax.optimization_barrier
# is stripped before fusion; value-identity bit tricks are constant-
# folded).  The working mitigation lives in ops/pipeline.py: the
# single-device EFT post stage is AOT-compiled at
# xla_backend_optimization_level=0 (_refine_dotp_post_o0).  The
# multi-device shard_map programs (parallel/ring.py) cannot O0 a
# sub-section and run fused: on an H100 they hold 3e-12 in ln Z against
# float64 (PERF.md), while on the CPU TEST backend they retain the hazard
# within their asserted tolerances (~1e-8 worst-case k=1).

def two_sum(a, b):
    """Error-free a + b: returns (s, err) with s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def two_diff(a, b):
    """Error-free a - b: returns (s, err) with s + err == a - b exactly."""
    s = a - b
    bb = s - a
    err = (a - (s - bb)) - (b + bb)
    return s, err


def _split(a):
    """Exact 12|12-bit split via mantissa masking: a == hi + lo where hi
    keeps the top 12 significand bits and lo = a - hi the remaining 12 —
    every partial product in :func:`two_prod` stays exactly representable
    in f32 (Dekker's requirement: 12+12 <= the 24-bit significand).

    Bit masking instead of the classical Veltkamp multiply-split
    (c = 4097*a; hi = c - (c - a)) on purpose: XLA may RECOMPUTE c inside a
    consumer fusion and contract the recomputation into an fma, silently
    breaking the rounded-split identity — observed on the CPU backend as
    sporadic ~2^-23-relative errors in two_prod's error term (round-4
    k=1 parity investigation).  Integer masking admits no floating-point
    rewriting, and is cheaper (one AND vs 2 mul + 2 sub)."""
    bits = jax.lax.bitcast_convert_type(a, jnp.int32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.int32(_LO12_MASK), a.dtype)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b: returns (p, err) with p + err == a * b exactly
    (Dekker's algorithm; no FMA required).

    See the COMPILER CAVEAT above two_sum for the XLA:CPU fusion hazard
    and its mitigation (regression-tested in tests/test_dfloat.py)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_add(xh, xl, yh, yl):
    """(xh,xl) + (yh,yl) as a normalized double-float."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    hi, lo = two_sum(s, e)
    return hi, lo


def df_square(xh, xl):
    """(xh,xl)^2 as a double-float (drops the negligible xl^2 term)."""
    p, e = two_prod(xh, xh)
    e = e + 2.0 * xh * xl
    hi, lo = two_sum(p, e)
    return hi, lo


def df_sum(hi, lo, axis):
    """Sum a double-float array along ``axis`` with error-free accumulation
    of the hi parts (compensated; lo parts accumulate in f32)."""
    # sequential two-sum over the (small) axis via a Python loop: the axis
    # is a static shape (candidate dims / coords), <= ~16 long.
    n = hi.shape[axis]
    hs = jnp.moveaxis(hi, axis, 0)
    ls = jnp.moveaxis(lo, axis, 0)
    acc_h = hs[0]
    acc_l = ls[0]
    for i in range(1, n):
        s, e = two_sum(acc_h, hs[i])
        acc_l = acc_l + (e + ls[i])
        acc_h, e2 = two_sum(s, acc_l)
        acc_l = e2
    return acc_h, acc_l


def df_mul(xh, xl, yh, yl):
    """(xh,xl) * (yh,yl) as a normalized double-float."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    hi, lo = two_sum(p, e)
    return hi, lo


def df_mul_f32(xh, xl, s):
    """(xh,xl) * s for a plain f32 factor ``s``."""
    p, e = two_prod(xh, s)
    e = e + xl * s
    hi, lo = two_sum(p, e)
    return hi, lo


def df_sqrt(xh, xl):
    """sqrt of a non-negative double-float via one Newton correction:
    s = sqrt_f32(hi); s' = s + (x - s^2) / (2 s)."""
    s = jnp.sqrt(xh)
    p, e = two_prod(s, s)                    # s^2 exactly
    rh, rl = df_add(xh, xl, -p, -e)          # x - s^2
    corr = jnp.where(s > 0, (rh + rl) / (2.0 * s), 0.0)
    hi, lo = two_sum(s, corr)
    return hi, lo


def df_reduce_sum(hi, lo, axis=0):
    """Sum a double-float array along ``axis`` by pairwise df_add tree —
    summation error stays at the double-float epsilon (~2^-48) instead of
    the f32 tree-reduction epsilon (~log2(N) * 2^-24)."""
    hi = jnp.moveaxis(hi, axis, 0)
    lo = jnp.moveaxis(lo, axis, 0)
    while hi.shape[0] > 1:
        n = hi.shape[0]
        if n % 2:
            hi = jnp.concatenate([hi, jnp.zeros_like(hi[:1])])
            lo = jnp.concatenate([lo, jnp.zeros_like(lo[:1])])
        hi, lo = df_add(hi[0::2], lo[0::2], hi[1::2], lo[1::2])
    return hi[0], lo[0]


def df_from_f64_np(x64):
    """Host helper: split a float64 numpy array into (hi, lo) float32 pair."""
    import numpy as np
    hi = np.asarray(x64, np.float32)
    lo = np.asarray(x64 - hi.astype(np.float64), np.float32)
    return hi, lo


def df_split_rows(x64, out_hi, out_lo, chunk: int = 65536):
    """Chunked hi/lo split of a (n, d) or (n,) f64 array into the leading
    rows/columns of preallocated f32 buffers (which may be padded larger).

    The naive split makes three full-size temporaries; on memory-bandwidth-
    starved hosts that triples the cost of what is otherwise two reads and
    two writes.  Writing hi straight into the output buffer and letting
    np.subtract compute in f64 and downcast into lo (casting='unsafe')
    removes every temporary: bit-identical results, measured 4x faster
    (0.5 vs 2.0 ms for 30k x 8 on this host)."""
    import numpy as np
    n = x64.shape[0]
    if x64.ndim == 1:
        for i in range(0, n, chunk):
            xc = x64[i:i + chunk]
            m = len(xc)
            h = out_hi[i:i + m]
            h[...] = xc                          # f64 -> f32 round
            # f64-promoted subtract, rounded into the f32 lo buffer:
            # exactly (xc - f64(hi)) rounded once, same as the naive form
            np.subtract(xc, h, out=out_lo[i:i + m], casting="unsafe")
    else:
        d = x64.shape[1]
        for i in range(0, n, chunk):
            xc = x64[i:i + chunk]
            m = len(xc)
            h = out_hi[i:i + m, :d]
            h[...] = xc
            np.subtract(xc, h, out=out_lo[i:i + m, :d], casting="unsafe")


def candidate_d2_df(qhi, qlo, rhi, rlo, idx):
    """Squared distances between rows of q and their candidate rows of r,
    in double-float precision.

    Args:
      qhi/qlo: (Nq, d) f32 pair of the (f64-whitened) query coordinates.
      rhi/rlo: (Nr, d) f32 pair of the reference coordinates.
      idx:     (Nq, k) int32 candidate row ids into r (negative = absent).

    Returns (d2_hi, d2_lo): (Nq, k) double-float squared distances; absent
    candidates get +inf.
    """
    safe = jnp.maximum(idx, 0)
    rh = rhi[safe]                       # (Nq, k, d) gathers
    rl = rlo[safe]
    # error-free coordinate difference: (qhi - rhi) + err + (qlo - rlo)
    dh, de = two_diff(qhi[:, None, :], rh)
    dl = de + (qlo[:, None, :] - rl)
    sh, sl = df_square(dh, dl)           # (Nq, k, d)
    d2h, d2l = df_sum(sh, sl, axis=2)
    bad = idx < 0
    d2h = jnp.where(bad, jnp.inf, d2h)
    d2l = jnp.where(bad, 0.0, d2l)
    return d2h, d2l

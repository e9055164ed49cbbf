"""Whitening (pre-whitening) of posterior samples.

The reference whitens by rotating samples into the covariance eigenbasis and
rescaling each axis to unit variance, with Jacobian = sqrt(det(C)); if any
eigenvalue is negative it warns and skips whitening with Jacobian = 1
(reference MCEvidence.py:842-947).

kNN *distances* are invariant to which unit-covariance whitener is used (any
two differ by an orthogonal map), so we use the symmetric ``eigh`` instead of
the reference's general ``eig`` — better conditioned, never complex, same
distances and same Jacobian (SURVEY.md §2.4).

Two implementations:
* numpy float64 (host) — the parity path; whitening is O(N d^2), not worth a
  device round-trip on its own.
* jnp — used inside the fused single-jit device program and the sharded
  (psum-moments) multi-device path.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class WhitenStats:
    """Covariance eigen-decomposition + Jacobian for a sample set."""

    cov: np.ndarray          # (d, d)
    eigvals: np.ndarray      # (d,)
    eigvecs: np.ndarray      # (d, d) columns
    log_jacobian: float      # ln sqrt(det C); 0.0 when not positive definite
    posdef: bool             # False => whitening skipped (reference fallback)

    @property
    def jacobian(self) -> float:
        return float(np.exp(self.log_jacobian))


def covariance(samples: np.ndarray) -> np.ndarray:
    """Sample covariance with the reference's normalization (np.cov: rows are
    variables, ddof=1; reference MCEvidence.py:865,916).

    np.cov's 0/0 RuntimeWarnings for n < 2 are suppressed — the resulting
    non-finite covariance is handled deliberately by ``whiten_stats``
    (warn-and-skip), which emits the intended signal."""
    import warnings
    with np.errstate(divide="ignore", invalid="ignore"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.cov(np.asarray(samples, dtype=np.float64).T)


def whiten_stats(samples: np.ndarray,
                 cov: Optional[np.ndarray] = None) -> WhitenStats:
    """Eigen-decompose the sample covariance; detect the degenerate case.

    Negative eigenvalue => warn and mark non-posdef: callers then skip the
    rotation and use Jacobian=1 (reference MCEvidence.py:867-878,920-931).

    ``cov``: precomputed covariance — callers that already hold centred
    samples pass their own GEMM result and skip np.cov's internal copies
    (the device-refine host prep).
    """
    c = covariance(samples) if cov is None else np.asarray(cov, np.float64)
    c = np.atleast_2d(c)
    if not np.all(np.isfinite(c)):
        # < 2 rows (np.cov divides by n-1 = 0) or NaN samples: eigh would
        # raise LinAlgError; treat as degenerate like the singular case
        logger.warning(
            "covariance is not finite (fewer than 2 samples, or NaN/inf "
            "coordinates): chain not whitened")
        d = c.shape[0]
        return WhitenStats(cov=c, eigvals=np.zeros(d), eigvecs=np.eye(d),
                           log_jacobian=0.0, posdef=False)
    try:
        eigvals, eigvecs = np.linalg.eigh(c)
    except np.linalg.LinAlgError as e:     # belt-and-braces: finite input
        logger.warning("covariance eigh failed (%s): chain not whitened", e)
        d = c.shape[0]
        return WhitenStats(cov=c, eigvals=np.zeros(d), eigvecs=np.eye(d),
                           log_jacobian=0.0, posdef=False)
    # <= 0: the reference only tests < 0 and then crashes on math.log(0) for
    # an exactly-singular covariance (a constant parameter column); treating
    # zero as degenerate matches the device paths and keeps the run alive.
    if np.any(eigvals <= 0):
        logger.warning(
            "covariance has non-positive eigenvalues %s: chain not whitened, "
            "estimated evidence may be inaccurate (consider fewer params "
            "via ndim)", eigvals)
        return WhitenStats(cov=c, eigvals=eigvals, eigvecs=eigvecs,
                           log_jacobian=0.0, posdef=False)
    # ln J = 0.5 ln det C = 0.5 sum ln eigvals
    log_j = 0.5 * float(np.sum(np.log(eigvals)))
    return WhitenStats(cov=c, eigvals=eigvals, eigvecs=eigvecs,
                       log_jacobian=log_j, posdef=True)


def apply_whiten(samples: np.ndarray, stats: WhitenStats) -> np.ndarray:
    """Rotate + rescale samples to unit covariance (reference
    ``diagonalise_chain``, MCEvidence.py:842-849).  No-op when not posdef."""
    if not stats.posdef:
        return np.asarray(samples, dtype=np.float64)
    s = np.asarray(samples, dtype=np.float64)
    return (s @ stats.eigvecs) / np.sqrt(stats.eigvals)


# --------------------------------------------------------------------------
# jnp variants (device path)
# --------------------------------------------------------------------------

def _whiten_from_cov_jnp(samples: jnp.ndarray, cov: jnp.ndarray):
    """Shared jit-traceable tail: eigh + posdef select + rotate/rescale.

    ONE home for the warn-and-skip policy on device (the host twin lives in
    ``whiten_stats``): non-posdef covariances fall back to the identity
    transform with log_jacobian = 0."""
    eigvals, eigvecs = jnp.linalg.eigh(cov)
    posdef = jnp.all(eigvals > 0)
    safe_vals = jnp.where(eigvals > 0, eigvals, 1.0)
    log_j = jnp.where(posdef, 0.5 * jnp.sum(jnp.log(safe_vals)), 0.0)
    white = jnp.dot(samples, eigvecs,
                    precision=jax.lax.Precision.HIGHEST) / jnp.sqrt(safe_vals)
    white = jnp.where(posdef, white, samples)
    return white, log_j, posdef


def whiten_jnp(samples: jnp.ndarray):
    """Fused device whitening: returns (whitened, log_jacobian, posdef).

    Uses a ``jnp.where`` select instead of Python control flow so it traces
    under jit.  Non-posdef covariances fall back to the identity transform
    with log_jacobian = 0, matching the host path.
    """
    s = samples
    mu = jnp.mean(s, axis=0, keepdims=True)
    xc = s - mu
    n = s.shape[0]
    cov = jnp.dot(xc.T, xc, precision=jax.lax.Precision.HIGHEST) / (n - 1)
    return _whiten_from_cov_jnp(s, cov)


def whiten_masked_jnp(samples: jnp.ndarray, valid: jnp.ndarray):
    """Device whitening from masked moments: rows with ``valid == 0``
    (bucket padding) are excluded from the covariance; the rotation is
    applied to all rows (pads are trimmed/masked downstream).  Returns
    (whitened, log_jacobian, posdef) like :func:`whiten_jnp`.

    Callers pre-centre the true rows on the host (fast_auto_evidence), so
    the uncentred-moment form ``sxx - n mu mu^T`` does not cancel."""
    w = valid[:, None]
    n = jnp.sum(valid)
    sw = samples * w
    sx = jnp.sum(sw, axis=0)
    sxx = jnp.dot(sw.T, samples, precision=jax.lax.Precision.HIGHEST)
    mean = sx / n
    cov = (sxx - n * jnp.outer(mean, mean)) / (n - 1.0)
    return _whiten_from_cov_jnp(samples, cov)


def whiten_moments(samples: jnp.ndarray, axis_name: Optional[str] = None):
    """Covariance from distributed first/second moments.

    For ``shard_map`` execution: each shard contributes (n, sum x, sum x x^T)
    and the moments are combined with ``psum`` over ``axis_name`` — the
    device-native replacement for gathering all samples to compute ``np.cov``
    (SURVEY.md §7 step 6).  Returns the (d, d) covariance (ddof=1).
    """
    n = jnp.asarray(samples.shape[0], dtype=samples.dtype)
    sx = jnp.sum(samples, axis=0)
    sxx = jnp.dot(samples.T, samples, precision=jax.lax.Precision.HIGHEST)
    if axis_name is not None:
        n = jax.lax.psum(n, axis_name)
        sx = jax.lax.psum(sx, axis_name)
        sxx = jax.lax.psum(sxx, axis_name)
    mean = sx / n
    cov = (sxx - n * jnp.outer(mean, mean)) / (n - 1.0)
    return cov

"""Evidence estimator tests: sklearn/float64 oracle parity and analytic truth
(SURVEY.md §4b-c; north-star parity target |dlnZ| < 1e-6, BASELINE.md)."""

import math

import numpy as np
import pytest
import scipy.special as sp
from sklearn.neighbors import NearestNeighbors

from mcevidence_tpu import MCEvidence, evidence_fn
from tests.conftest import make_gaussian_chain


def oracle_auto_evidence(theta, lnl, weights, kmax, prior_volume=1.0):
    """Independent float64 implementation of the Heavens et al. estimator
    using sklearn, mirroring the reference formula (MCEvidence.py:1107-1131)."""
    n, ndim = theta.shape
    cov = np.cov(theta.T)
    ev, evec = np.linalg.eigh(cov)
    jac = math.sqrt(np.linalg.det(cov))
    s = (theta @ evec) / np.sqrt(ev)
    D, _ = NearestNeighbors(n_neighbors=kmax + 1).fit(s).kneighbors(s)
    lmax = lnl.max()
    fs = np.exp(lnl - lmax)
    out = []
    for k in range(1, kmax):
        vol = math.pi ** (ndim / 2) * D[:, k] ** ndim / sp.gamma(1 + ndim / 2)
        dotp = np.dot(vol / weights, fs)
        amax = dotp / (n * k + 1.0)
        out.append(math.log(weights.sum() * amax * jac) + lmax
                   - math.log(prior_volume))
    return np.array(out)


def test_parity_vs_sklearn_oracle(gaussian_chain):
    theta, lnl = gaussian_chain
    w = np.ones(len(theta))
    ours = evidence_fn(theta, lnl, kmax=4, engine="xla")
    oracle = oracle_auto_evidence(theta, lnl, w, kmax=4)
    np.testing.assert_allclose(ours, oracle, rtol=0, atol=1e-6)


def test_parity_with_weights(rng):
    theta, lnl = make_gaussian_chain(rng, n=1500, ndim=3)
    w = rng.integers(1, 5, size=len(theta)).astype(float)
    ours = evidence_fn(theta, lnl, weights=w, kmax=3, engine="xla")
    oracle = oracle_auto_evidence(theta, lnl, w, kmax=3)
    np.testing.assert_allclose(ours, oracle, atol=1e-6)


def test_analytic_gaussian_truth(rng):
    # Samples drawn exactly from a normalized Gaussian likelihood:
    # integral L dtheta = 1, so with V_prior = 1, lnZ -> 0.
    theta, lnl = make_gaussian_chain(rng, n=4000, ndim=4)
    lnz = evidence_fn(theta, lnl, kmax=2, engine="xla")
    assert abs(lnz[0]) < 0.15


def test_prior_volume_shift(gaussian_chain):
    theta, lnl = gaussian_chain
    z1 = evidence_fn(theta, lnl, kmax=2, prior_volume=1.0, engine="xla")
    z2 = evidence_fn(theta, lnl, kmax=2, prior_volume=10.0, engine="xla")
    np.testing.assert_allclose(z1 - z2, math.log(10.0), atol=1e-12)


def test_cross_evidence(rng):
    theta, lnl = make_gaussian_chain(rng, n=3000, ndim=3)
    half = len(theta) // 2
    lnz = evidence_fn(theta[:half], lnl[:half],
                      samples2=theta[half:], kmax=3, engine="xla")
    # cross evidence on an exact-likelihood chain is also ~0...
    assert abs(lnz[0]) < 0.25
    # ...and quirk Q2 holds: returned columns are 2nd..kmax-th NN (the k=0
    # genuine 1st-NN column is computed then dropped).
    assert lnz.shape == (2,)


def test_facade_dict_chain(gaussian_chain):
    theta, lnl = gaussian_chain
    mce = MCEvidence({"samples": theta, "loglikes": lnl},
                     kmax=3, verbose=0, engine="xla")
    out = mce.evidence()
    assert out.shape == (2,)
    oracle = oracle_auto_evidence(theta, lnl, np.ones(len(theta)), kmax=3)
    np.testing.assert_allclose(out, oracle, atol=1e-6)
    assert mce.info["Nsamples_read"] == len(theta)
    assert mce.info["NparamsCosmo"] == theta.shape[1]


def test_facade_kmax_floor(gaussian_chain):
    theta, lnl = gaussian_chain
    mce = MCEvidence({"samples": theta, "loglikes": lnl},
                     kmax=0, verbose=0, engine="xla")
    assert mce.kmax == 2   # reference floors kmax at 2 (MCEvidence.py:694)


def test_facade_sampler_class(rng):
    # ischain=False path, fixed from reference quirk Q3.
    class ToySampler:
        ndim = 3

        def Sampler(self, nsamples=1000):
            return make_gaussian_chain(np.random.default_rng(7),
                                       n=nsamples, ndim=3)

    mce = MCEvidence(ToySampler(), ischain=False, nsample=1200,
                     kmax=2, verbose=0, engine="xla")
    out = mce.evidence()
    assert out.shape == (1,)
    assert abs(out[0]) < 0.3


def test_facade_split_cross(rng):
    theta, lnl = make_gaussian_chain(rng, n=3000, ndim=3)
    mce = MCEvidence({"samples": theta, "loglikes": lnl}, split=True,
                     kmax=2, verbose=0, seed=0, engine="xla")
    assert mce.pair.split
    assert mce.pair.s1.nsamples == 1500
    out = mce.evidence()
    assert abs(out[0]) < 0.3


def test_facade_importance_sampling(gaussian_chain):
    theta, lnl = gaussian_chain
    # reweighting by a constant factor exp(-c) shifts SumW only: lnZ shifts
    # by -c exactly (quirk Q7 semantics).
    c = 0.7
    base = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2,
                      verbose=0, engine="xla").evidence()
    rew = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2, verbose=0,
                     isfunc=lambda s: np.full(len(s), c),
                     engine="xla").evidence()
    np.testing.assert_allclose(rew - base, -c, atol=1e-12)


def test_facade_batching_brange(rng):
    theta, lnl = make_gaussian_chain(rng, n=2000, ndim=3)
    mce = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2, verbose=0,
                     nbatch=2, brange=[2.5, 3.0], bscale="logpower",
                     engine="xla")
    out = mce.evidence()
    assert out.shape == (2, 1)   # (nbatch, kmax-1)
    # batch sizes 10^2.5, 10^3
    np.testing.assert_array_equal(mce.batch_plan.batch_sizes_s1(), [316, 1000])


def test_facade_bscale_linear_works(rng):
    # reference NameErrors on bscale='linear' (quirk Q4); ours must work.
    theta, lnl = make_gaussian_chain(rng, n=1000, ndim=3)
    mce = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2, verbose=0,
                     nbatch=2, brange=[300, 600], bscale="linear",
                     engine="xla")
    np.testing.assert_array_equal(mce.batch_plan.batch_sizes_s1(), [300, 600])
    out = mce.evidence()
    assert out.shape == (2, 1)


def test_pos_lnp_flag(gaussian_chain):
    theta, lnl = gaussian_chain
    a = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2, verbose=0,
                   engine="xla").evidence()
    # feeding -lnL and flipping pos_lnp must give the identical result
    b = MCEvidence({"samples": theta, "loglikes": -lnl}, kmax=2, verbose=0,
                   engine="xla").evidence(pos_lnp=True)
    np.testing.assert_allclose(a, b, atol=1e-12)


def test_fused_fast_path_matches_refine(gaussian_chain):
    theta, lnl = gaussian_chain
    refine = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=3,
                        verbose=0, engine="xla").evidence()
    fast = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=3,
                      verbose=0, engine="xla",
                      precision="fast").evidence()
    np.testing.assert_allclose(fast, refine, atol=3e-3)


def test_fused_fast_path_importance_shift(gaussian_chain):
    theta, lnl = gaussian_chain
    c = 0.4
    base = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2, verbose=0,
                      engine="xla", precision="fast").evidence()
    rew = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2, verbose=0,
                     isfunc=lambda s: np.full(len(s), c), engine="xla",
                     precision="fast").evidence()
    np.testing.assert_allclose(rew - base, -c, atol=1e-5)


def test_covtype_single_cross(rng):
    # covtype='single': s1 whitened with cov(s1), s2 with cov(s2), Jacobian
    # from s1 (reference MCEvidence.py:1080-1086) — check against a direct
    # oracle built the same way.
    theta, lnl = make_gaussian_chain(rng, n=1600, ndim=3)
    s1, l1, s2 = theta[:900], lnl[:900], theta[900:]
    ours = evidence_fn(s1, l1, samples2=s2, kmax=2, covtype="single",
                       engine="xla")
    cov1 = np.cov(s1.T)
    ev1, evec1 = np.linalg.eigh(cov1)
    cov2 = np.cov(s2.T)
    ev2, evec2 = np.linalg.eigh(cov2)
    w1 = (s1 @ evec1) / np.sqrt(ev1)
    w2 = (s2 @ evec2) / np.sqrt(ev2)
    D, _ = NearestNeighbors(n_neighbors=2).fit(w2).kneighbors(w1)
    lmax = l1.max()
    fs = np.exp(l1 - lmax)
    ndim = 3
    vol = math.pi ** (ndim / 2) * D[:, 1] ** ndim / sp.gamma(1 + ndim / 2)
    amax = np.dot(vol, fs) / (len(s1) * 2 + 1.0)   # k0=0: col 1 -> k_nn=2
    oracle = math.log(len(s1) * amax * math.sqrt(np.linalg.det(cov1))) + lmax
    np.testing.assert_allclose(ours[0], oracle, atol=1e-6)


def test_rand_subsampling(rng):
    theta, lnl = make_gaussian_chain(rng, n=2000, ndim=3)
    mce = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2, verbose=0,
                     nbatch=2, brange=[2.5, 3.0], bscale="logpower",
                     engine="xla", seed=3)
    out = mce.evidence(rand=True)
    assert out.shape == (2, 1)
    assert np.all(np.isfinite(out))


def test_rand_oversized_batch_raises(rng):
    theta, lnl = make_gaussian_chain(rng, n=500, ndim=3)
    mce = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2, verbose=0,
                     nbatch=1, brange=[3.0, 3.0], bscale="logpower",
                     engine="xla")
    with pytest.raises(ValueError, match="ntotal"):
        mce.evidence(rand=True)


def test_ball_volume_const_vs_scipy():
    from mcevidence_tpu.ops.estimator import log_ball_volume_const
    import scipy.special as sp
    for d in (1, 2, 7, 15, 20):
        ref = np.log(np.pi ** (d / 2) / sp.gamma(1 + d / 2))
        np.testing.assert_allclose(log_ball_volume_const(d), ref, rtol=1e-13)


def test_evidence_with_error(tmp_path, rng):
    from mcevidence_tpu.evidence import evidence_with_error
    for c in (1, 2, 3, 4):
        theta, lnl = make_gaussian_chain(rng, n=800, ndim=3)
        np.savetxt(tmp_path / f"ch_{c}.txt",
                   np.column_stack([np.ones(800), -lnl, theta]))
    mean, err, per_chain = evidence_with_error(str(tmp_path / "ch"),
                                               kmax=2, engine="xla")
    assert per_chain.shape == (4, 1)
    assert err[0] > 0
    # 4 independent exact chains: scatter should bracket the truth (lnZ~0)
    assert abs(mean[0]) < max(10 * err[0], 0.3)
    with pytest.raises(ValueError, match=">= 2 chains"):
        evidence_with_error(str(tmp_path / "ch_1.txt"), kmax=2)


def test_device_precision_matches_refine(rng, gaussian_chain):
    # device-resident double-float path: ~1e-7 of the f64 refine oracle
    theta, lnl = gaussian_chain
    w = rng.integers(1, 4, size=len(theta)).astype(float)
    ref = evidence_fn(theta, lnl, weights=w, kmax=4, precision="refine",
                      engine="xla")
    dev = evidence_fn(theta, lnl, weights=w, kmax=4, precision="device",
                      engine="xla")
    np.testing.assert_allclose(dev, ref, atol=1e-6)


def test_device_precision_mcevidence(rng, gaussian_chain):
    theta, lnl = gaussian_chain
    chain = {"samples": theta, "loglikes": lnl}
    ref = MCEvidence(chain, verbose=0, kmax=3, engine="xla",
                     precision="refine").evidence()
    dev = MCEvidence(chain, verbose=0, kmax=3, engine="xla",
                     precision="device").evidence()
    np.testing.assert_allclose(dev, ref, atol=1e-6)


def test_device_precision_cross(rng, gaussian_chain):
    # cross mode on the device path (combined covariance, k0 semantics)
    theta, lnl = gaussian_chain
    s1, l1 = theta[:1100], lnl[:1100]
    ref = evidence_fn(s1, l1, samples2=theta[1100:], kmax=3,
                      precision="refine", engine="xla")
    dev = evidence_fn(s1, l1, samples2=theta[1100:], kmax=3,
                      precision="device", engine="xla")
    np.testing.assert_allclose(dev, ref, atol=1e-8)


def test_device_precision_offset_coordinates(rng):
    # whitened-but-unshifted chains can sit at ~1e3 sigma offsets; the f32
    # cast for selection must be centred in f64 first or candidate ranking
    # noise exceeds what pad_candidates absorbs (regression: 8e-7 bias)
    mean = np.array([0.0222, 0.12, 1.041])
    sig = np.array([0.0002, 0.002, 0.0005])
    theta = rng.normal(mean, sig, size=(4000, 3))
    dm = (theta - mean) / sig
    lnl = (-0.5 * np.sum(dm * dm, axis=1)
           - 1.5 * np.log(2 * np.pi) - np.sum(np.log(sig)))
    ref = evidence_fn(theta, lnl, kmax=3, precision="refine", engine="xla")
    dev = evidence_fn(theta, lnl, kmax=3, precision="device", engine="xla")
    np.testing.assert_allclose(dev, ref, atol=1e-8)


# ---------------------------------------------------------------------------
# Bayesian-bootstrap error bars (evidence_bootstrap)
# ---------------------------------------------------------------------------

def test_bootstrap_matches_point_estimate(rng):
    from mcevidence_tpu import evidence_bootstrap, evidence_fn
    theta, lnl = make_gaussian_chain(rng, n=1500, ndim=3)
    chain = {"samples": theta, "loglikes": lnl}
    lnz, err, reps = evidence_bootstrap(chain, kmax=3, n_boot=32, seed=7,
                                        engine="xla")
    point = evidence_fn(theta, lnl, kmax=3, engine="xla")
    np.testing.assert_allclose(lnz, point, atol=1e-9)
    assert reps.shape == (32, 2)
    assert np.all(err > 0)
    # replicates scatter around the point estimate, not away from it
    assert np.all(np.abs(reps.mean(axis=0) - lnz) < 4 * err)


def test_bootstrap_error_calibration(rng):
    """The bootstrap error should match the true sampler scatter within a
    small factor (it is a variance estimate, not an exact one)."""
    from mcevidence_tpu import evidence_bootstrap
    lnzs = []
    for i in range(12):
        theta, lnl = make_gaussian_chain(np.random.default_rng(100 + i),
                                         n=1200, ndim=3)
        lnzs.append(evidence_fn(theta, lnl, kmax=2, engine="xla")[0])
    true_scatter = np.std(lnzs, ddof=1)
    theta, lnl = make_gaussian_chain(rng, n=1200, ndim=3)
    _, err, _ = evidence_bootstrap({"samples": theta, "loglikes": lnl},
                                   kmax=2, n_boot=64, seed=3, engine="xla")
    # the Dirichlet bootstrap captures the likelihood-sum variance, which
    # dominates here (measured: err within ~2% of the true scatter; keep a
    # loose factor for seed robustness)
    assert err[0] < 3 * true_scatter
    assert err[0] > true_scatter / 3


def test_bootstrap_weighted_and_importance(rng):
    from mcevidence_tpu import evidence_bootstrap
    theta, lnl = make_gaussian_chain(rng, n=1000, ndim=3)
    w = rng.integers(1, 6, size=len(theta)).astype(float)
    chain = {"samples": theta, "loglikes": lnl, "weights": w}
    lnz, err, _ = evidence_bootstrap(chain, kmax=2, n_boot=16, seed=1,
                                     engine="xla")
    assert np.isfinite(lnz).all() and np.all(err > 0)


def test_bootstrap_cross_mode(rng):
    from mcevidence_tpu import evidence_bootstrap
    theta, lnl = make_gaussian_chain(rng, n=1600, ndim=3)
    lnz, err, reps = evidence_bootstrap(
        {"samples": theta, "loglikes": lnl}, kmax=2, n_boot=24, seed=5,
        split=True, engine="xla")
    assert np.isfinite(lnz).all() and np.all(err > 0)
    # samples drawn from a normalized likelihood with V_prior=1: lnZ ~ 0
    assert abs(lnz[0]) < 0.3
    assert np.all(np.abs(reps.mean(axis=0) - lnz) < 5 * err)


# ---------------------------------------------------------------------------
# review fixes: batch truncation, device overflow fallback, batched pipeline
# ---------------------------------------------------------------------------

def test_constant_brange_last_batch_truncates(rng):
    """'constant' bscale batch sizes are cumulative; the last one exceeds
    the chain and must truncate like the reference's slicing, not crash."""
    theta, lnl = make_gaussian_chain(rng, n=120, ndim=3)
    mc = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2,
                    nbatch=4, brange=40, verbose=0, engine="xla")
    out = mc.evidence()
    assert out.shape == (4, 1)
    assert np.all(np.isfinite(out))


def test_device_overflow_falls_back_to_host_refine(rng, monkeypatch):
    from mcevidence_tpu.ops import pipeline
    theta, lnl = make_gaussian_chain(rng, n=600, ndim=3)

    def bad_fused(*a, **k):
        flat = np.zeros(2 * 2 + 1)
        flat[0] = np.inf
        return flat
    monkeypatch.setattr(pipeline, "fused_refine_dotp", bad_fused)
    got = pipeline.device_refine_evidence(theta, lnl, kmax=2, engine="xla")
    want = pipeline.host_refine_evidence(theta, lnl, kmax=2, engine="xla")
    np.testing.assert_allclose(got, want, atol=1e-12)
    ref = evidence_fn(theta, lnl, kmax=2, engine="xla")
    np.testing.assert_allclose(got, ref, atol=1e-9)


def test_device_refine_packed2_engine_matches_xla(rng):
    """The engine name plumbs through the device-refine pipeline: 'auto'
    resolves to the platform's engine (xla on this CPU backend) and gives
    the explicit engine's result."""
    from mcevidence_tpu.ops import pipeline
    theta, lnl = make_gaussian_chain(rng, n=300, ndim=4)
    got = pipeline.device_refine_evidence(theta, lnl, kmax=2,
                                          engine="auto")
    want = pipeline.device_refine_evidence(theta, lnl, kmax=2, engine="xla")
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_device_hbm_guard_falls_back_to_host(rng, caplog, monkeypatch):
    """The single-device N ceiling: when the program's device-memory plan
    exceeds the device budget, the call must degrade to the host-refine
    path with a logged decision — never reach the device program (where it
    would die as a mid-run XLA OOM)."""
    import logging

    from mcevidence_tpu.ops import pipeline
    theta, lnl = make_gaussian_chain(rng, n=600, ndim=3)
    monkeypatch.setattr(pipeline, "device_memory_budget_bytes",
                        lambda device=None: 10_000)

    def boom(*a, **k):
        raise AssertionError("device program dispatched past the HBM guard")
    monkeypatch.setattr(pipeline, "fused_refine_dotp", boom)
    with caplog.at_level(logging.WARNING,
                         logger="mcevidence_tpu.ops.pipeline"):
        got = pipeline.device_refine_evidence(theta, lnl, kmax=2,
                                              engine="xla")
    assert any("device memory" in r.message and "budget" in r.message
               for r in caplog.records)
    want = pipeline.host_refine_evidence(theta, lnl, kmax=2, engine="xla")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_hbm_estimate_shape_math():
    """The device-memory plan: linear in N on the Triton engine (the
    (rows, k_sel, dpad) refinement temporaries dominate); the xla engine
    adds its (rows, 2048) f32 distance tile.  The budget is a share of
    the device's reported bytes_limit: on an 80 GB card the Planck
    headline shape fits with wide margin, and the xla engine's tile puts
    the edge at N ~ 2^23."""
    from mcevidence_tpu.ops.pipeline import (DEVICE_MEMORY_SHARE,
                                             device_memory_budget_bytes,
                                             estimate_device_refine_hbm_bytes)
    budget = device_memory_budget_bytes(
        _FakeDevice({"bytes_limit": 80 * 2 ** 30}))
    assert budget == int(80 * 2 ** 30 * DEVICE_MEMORY_SHARE)
    assert device_memory_budget_bytes(_FakeDevice(None)) is None
    est = estimate_device_refine_hbm_bytes
    headline = est(65536, 65536, 8, 9, engine="triton")
    assert headline < budget / 100
    # ~linear growth in N (pow-2 buckets: exactly 2x per doubling)
    assert est(2 ** 20, 2 ** 20, 8, 9, engine="triton") == pytest.approx(
        2 * est(2 ** 19, 2 ** 19, 8, 9, engine="triton"), rel=0.01)
    # the xla path's distance tile, and the kernel's large-k route to it
    tile = 2 ** 20 * 2048 * 4
    assert est(2 ** 20, 2 ** 20, 8, 9) - est(
        2 ** 20, 2 ** 20, 8, 9, engine="triton") == tile
    assert est(2 ** 20, 2 ** 20, 8, 20, engine="triton") == est(
        2 ** 20, 2 ** 20, 8, 20)
    assert est(2 ** 22, 2 ** 22, 8, 9) < budget < est(2 ** 23, 2 ** 23, 8, 9)
    # REGRESSION (round-5 review): equal-size cross jobs (the even-N
    # --cross split, matched-size two-chain runs) allocate separate
    # rhi/rlo — the plan must charge the ref-coords term on the explicit
    # cross flag, not on a row-count comparison
    auto = estimate_device_refine_hbm_bytes(2 ** 19, 2 ** 19, 8, 9)
    crossed = estimate_device_refine_hbm_bytes(2 ** 19, 2 ** 19, 8, 9,
                                               cross=True)
    from mcevidence_tpu.parallel.ring import _dpad_class
    assert crossed - auto == 4 * 2 ** 19 * _dpad_class(8) * 4


def test_refine_chunking_is_bitwise_identical(rng, monkeypatch):
    """Streaming the f64 refinement over query-row chunks (bounded host
    peak at the N ceiling) must be bit-identical to one-shot — including
    the self-match zeroing, whose row ids are chunk-global."""
    import jax.numpy as jnp

    from mcevidence_tpu.ops import knn
    theta = rng.normal(size=(512, 5))
    d2, idx = knn.knn_select_xla(
        jnp.asarray(theta, jnp.float32), jnp.asarray(theta, jnp.float32),
        6, self_mode=True)
    one_shot = knn._refine_knn_f64_all(theta, theta, np.asarray(idx), True)
    monkeypatch.setattr(knn, "_REFINE_CHUNK_BYTES", 10_000)  # ~41-row chunks
    chunked = knn._refine_knn_f64_all(theta, theta, np.asarray(idx), True)
    np.testing.assert_array_equal(one_shot, chunked)


def test_device_tiny_reference_no_spurious_retry(rng, caplog):
    """n_ref <= kmax: every reference row is a candidate, so the thin-margin
    guard must not warn or retry (it can never be widened)."""
    import logging

    from mcevidence_tpu.ops.pipeline import device_refine_evidence
    theta, lnl = make_gaussian_chain(rng, n=4, ndim=2)
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu.ops.pipeline"):
        out = device_refine_evidence(theta, lnl, kmax=4, engine="xla")
    assert not any("thin" in r.message for r in caplog.records)
    assert out.shape == (3,)


def test_device_retry_on_equidistant_ties(rng, caplog):
    """A 3-D integer lattice gives every interior point 6 equidistant
    nearest neighbours: with the default pad (k_sel=6) the kmax-th and the
    worst kept candidate tie exactly, so the sufficiency guard must fire
    ONE retry (k_sel=26 — the regime whose Pallas kernels overflowed
    scoped VMEM before the round-3 fix), after which the sqrt(3)-shell
    margin is wide and the result must match the host refine path."""
    import itertools
    import logging

    from mcevidence_tpu.ops.pipeline import (device_refine_evidence,
                                             host_refine_evidence)
    theta = np.array(list(itertools.product(range(8), repeat=3)), np.float64)
    lnl = -0.05 * np.sum((theta - 3.5) ** 2, axis=1)
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu.ops.pipeline"):
        got = device_refine_evidence(theta, lnl, kmax=2, engine="xla")
    assert any("thin margins" in r.message and "re-running" in r.message
               for r in caplog.records)
    assert not any(r.levelno >= logging.WARNING and "thin" in r.message
                   for r in caplog.records)
    want = host_refine_evidence(theta, lnl, kmax=2, engine="xla")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_fused_refine_dotp_batch_matches_per_cell(rng):
    """The batched device-refine pipeline agrees with per-cell dispatch
    exactly."""
    import jax.numpy as jnp

    from mcevidence_tpu.ops.pipeline import (_device_refine_prepare,
                                             fused_refine_dotp,
                                             fused_refine_dotp_batch)
    chains = [make_gaussian_chain(np.random.default_rng(40 + i),
                                  n=500, ndim=3) for i in range(3)]
    devs, hosts, per_cell = [], [], []
    for th, lnl in chains:
        dev, host = _device_refine_prepare(th, lnl, None, 3, 4, "xla")
        dev = {k: np.array(v) for k, v in dev.items()}
        devs.append(dev)
        hosts.append(host)
        per_cell.append(np.asarray(fused_refine_dotp(
            dev["qhi"], dev["qlo"], dev["rhi"], dev["rlo"], dev["scalh"],
            dev["scall"], dev["valid"], dev["n_true"], dev["ndim"],
            dev["inv_s2"], k_sel=host["k_sel"], kmax=3, engine="xla")))
    names = ("qhi", "qlo", "rhi", "rlo", "scalh", "scall", "valid",
             "n_true", "ndim", "inv_s2")
    stk = {k: jnp.stack([d[k] for d in devs]) for k in names}
    batched = np.asarray(fused_refine_dotp_batch(
        *(stk[k] for k in names), k_sel=hosts[0]["k_sel"], kmax=3,
        engine="xla"))
    np.testing.assert_allclose(batched, np.stack(per_cell), rtol=0,
                               atol=1e-6)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_adversarial_inputs_graceful(rng):
    """NaN lnL / inf weight propagate (reference-like); tiny and degenerate
    chains produce finite results or clean warnings — never tracebacks."""
    th = rng.normal(size=(400, 3))
    lnl = -0.5 * np.sum(th * th, axis=1)
    l2 = lnl.copy()
    l2[5] = np.nan
    assert np.isnan(evidence_fn(th, l2, kmax=2, engine="xla")[0])
    w = np.ones(400)
    w[3] = np.inf
    assert np.isinf(evidence_fn(th, lnl, weights=w, kmax=2, engine="xla")[0])
    tc = th.copy()
    tc[:, 2] = 1.0            # constant column: warn-and-skip whitening
    assert np.isfinite(evidence_fn(tc, lnl, kmax=2, engine="xla")[0])
    assert np.isfinite(evidence_fn(th[:2], lnl[:2], kmax=2,
                                   engine="xla")[0])
    out = evidence_fn(th[:1], lnl[:1], kmax=2, engine="xla")
    # 1 row: no neighbours exist — the k=1 column is undefined (NaN) but the
    # k = 1..kmax-1 return contract holds (round-4 review: shape used to
    # vary by precision mode)
    assert out.shape == (1,)
    assert np.all(np.isnan(out))


def test_pooled_staging_self_check(rng):
    """Pooled staging buffers are reused, and a prepared cell's device
    arrays never change when the next prep refills the same buffers (the
    prep waits for its host-to-device copies before returning)."""
    from mcevidence_tpu.ops import pipeline

    a = pipeline._pooled("selfcheck", (8,), np.float32)
    b = pipeline._pooled("selfcheck", (8,), np.float32)
    assert a is b
    chains = [make_gaussian_chain(np.random.default_rng(s), n=300, ndim=3)
              for s in (1, 2)]
    dev1, _ = pipeline._device_refine_prepare(*chains[0], None, 2, 4, "xla")
    want = {k: np.array(v) for k, v in dev1.items()}
    pipeline._device_refine_prepare(*chains[1], None, 2, 4, "xla")
    for k, v in dev1.items():
        np.testing.assert_array_equal(np.asarray(v), want[k])


def test_device_ndim_over_layout_limit_falls_back(rng, caplog):
    """ndim > DEVICE_NDIM_MAX (17+ parameters): precision='device' must
    degrade to host refine with a log line, not crash on an internal
    layout constant (round-4 review finding)."""
    import logging

    theta = rng.normal(size=(400, 17))
    lnl = -0.5 * np.sum(theta * theta, axis=1)
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu.ops.pipeline"):
        got = evidence_fn(theta, lnl, kmax=2, precision="device",
                          engine="xla")
    want = evidence_fn(theta, lnl, kmax=2, precision="refine", engine="xla")
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert any("device layout limit" in r.message for r in caplog.records)


def test_device_degenerate_inputs_never_traceback(rng):
    """The device path honors the degenerate-input contract the host path
    already has (whiten_stats warn-and-skip): NaN rows and 1-row chains
    degrade, never LinAlgError (round-4 review finding)."""
    theta = rng.normal(size=(300, 3))
    lnl = -0.5 * np.sum(theta * theta, axis=1)
    bad = theta.copy()
    bad[5] = np.nan
    out = evidence_fn(bad, lnl, kmax=2, precision="device", engine="xla")
    assert out.shape == (1,)          # degraded, not crashed
    out1 = evidence_fn(theta[:1], lnl[:1], kmax=2, precision="device",
                       engine="xla")
    assert out1.shape == (1,)


def test_fast_mode_kmax_beyond_n_marks_nan(rng):
    """REGRESSION (round-4 review): with n < kmax the selection fills the
    absent-neighbour columns with +inf, which used to propagate
    log(inf)=+inf into the returned evidence.  Those columns must come
    back NaN (undefined), matching the host parity path's padding, and
    the defined columns must still agree with the host path."""
    from mcevidence_tpu.ops.pipeline import (fast_auto_evidence,
                                             host_refine_evidence)
    n, kmax = 3, 5
    s = rng.normal(size=(n, 2))
    lnl = -0.5 * np.sum(s * s, axis=1)
    fast = np.asarray(fast_auto_evidence(s, lnl, kmax=kmax))
    assert fast.shape == (kmax - 1,)
    assert np.all(np.isfinite(fast[: n - 1]))
    assert np.all(np.isnan(fast[n - 1:]))      # k >= n: no k-th neighbour
    host = host_refine_evidence(s, lnl, kmax=kmax)
    np.testing.assert_allclose(fast[: n - 1], host[: n - 1], atol=5e-4)
    assert np.all(np.isnan(host[n - 1:]))


# ---- round-4 chains/evidence review regressions ---------------------------

def test_tiny_split_partition_nan_pads_instead_of_crash(rng):
    """REGRESSION: split mode with a reference partition smaller than kmax
    used to die with a broadcast ValueError (exact_knn clips the column
    count); undefined k columns must come back NaN instead."""
    from mcevidence_tpu.evidence import MCEvidence
    s = rng.normal(size=(8, 2))
    lnl = -0.5 * np.sum(s * s, axis=1)
    out = MCEvidence({"samples": s, "loglikes": lnl}, split=True, kmax=5,
                     seed=0, verbose=0).evidence()
    assert out.shape == (4,)
    assert np.any(np.isfinite(out))        # small-k columns defined
    assert np.any(np.isnan(out))           # k >= |s2| undefined, not a crash


def test_evidence_fn_short_chain_shape_consistent_across_precisions(rng):
    """evidence_fn must honor the k = 1..kmax-1 return contract (NaN-pad)
    in every precision mode, not just 'device'."""
    from mcevidence_tpu.evidence import evidence_fn
    s = rng.normal(size=(3, 2))
    lnl = -0.5 * np.sum(s * s, axis=1)
    for precision in ("refine", "device"):
        out = evidence_fn(s, lnl, kmax=5, precision=precision)
        assert out.shape == (4,), precision
        assert np.all(np.isnan(out[2:])), precision


def test_unknown_precision_and_covtype_raise(rng):
    from mcevidence_tpu.evidence import MCEvidence, evidence_fn
    s = rng.normal(size=(50, 2))
    lnl = -0.5 * np.sum(s * s, axis=1)
    chain = {"samples": s, "loglikes": lnl}
    with pytest.raises(ValueError, match="precision"):
        MCEvidence(chain, precision="exact", verbose=0)
    with pytest.raises(ValueError, match="covtype"):
        MCEvidence(chain, covtype="typo", verbose=0)
    with pytest.raises(ValueError, match="covtype"):
        MCEvidence(chain, verbose=0).evidence(covtype="typo")
    with pytest.raises(ValueError, match="precision"):
        evidence_fn(s, lnl, precision="float64")


def test_ndim_overreach_clamped_with_warning(rng, caplog):
    """ndim > nparam used to silently mix d=ndim ball volumes with
    d=nparam distances -> wrong ln Z."""
    import logging
    from mcevidence_tpu.evidence import MCEvidence
    s = rng.normal(size=(400, 3))
    lnl = -0.5 * np.sum(s * s, axis=1)
    chain = {"samples": s, "loglikes": lnl}
    with caplog.at_level(logging.WARNING, logger="mcevidence_tpu.evidence"):
        mc = MCEvidence(chain, ndim=7, verbose=0)
    assert mc.ndim == 3
    assert any("clamping" in r.message for r in caplog.records)
    np.testing.assert_allclose(
        mc.evidence(), MCEvidence(chain, verbose=0).evidence(), atol=1e-12)


def test_evidence_fn_device_accepts_list_samples2(rng):
    """The device branch used to crash on non-ndarray samples2 because the
    conversion happened after the mode dispatch."""
    from mcevidence_tpu.evidence import evidence_fn
    s = rng.normal(size=(60, 2))
    lnl = -0.5 * np.sum(s * s, axis=1)
    s2 = rng.normal(size=(60, 2)).tolist()
    dev = evidence_fn(s, lnl, samples2=s2, kmax=2, precision="device")
    ref = evidence_fn(s, lnl, samples2=np.asarray(s2), kmax=2,
                      precision="refine")
    np.testing.assert_allclose(dev, ref, atol=1e-8)


def test_nbatch_without_brange_runs_one_batch(rng, caplog):
    """nbatch>1 with brange=None used to recompute the full O(N^2) pass
    nbatch-1 times and discard the results."""
    import logging
    from mcevidence_tpu.evidence import MCEvidence
    s = rng.normal(size=(200, 2))
    lnl = -0.5 * np.sum(s * s, axis=1)
    with caplog.at_level(logging.WARNING, logger="mcevidence_tpu.utils.batch"):
        mc = MCEvidence({"samples": s, "loglikes": lnl}, nbatch=3, verbose=0)
    assert mc.batch_plan.nbatch == 1
    assert any("nbatch=3 ignored" in r.message for r in caplog.records)
    out = mc.evidence()
    assert out.shape == (4,)
    np.testing.assert_allclose(
        out, MCEvidence({"samples": s, "loglikes": lnl}, verbose=0).evidence(),
        atol=1e-12)

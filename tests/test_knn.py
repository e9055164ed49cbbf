"""kNN engine tests: exactness vs sklearn float64 (SURVEY.md §4c)."""

import numpy as np
import pytest
from sklearn.neighbors import NearestNeighbors

from mcevidence_tpu.ops.knn import exact_knn, knn_select_xla, refine_knn_f64


def _sk_dist(query, ref, k):
    return NearestNeighbors(n_neighbors=k).fit(ref).kneighbors(query)[0]


def test_self_mode_matches_sklearn(rng):
    x = rng.normal(size=(500, 5))
    ours = exact_knn(x, None, 6, engine="xla")
    sk = _sk_dist(x, x, 6)
    np.testing.assert_allclose(ours, sk, rtol=0, atol=1e-9)
    # column 0 is the self match at exactly 0
    assert np.all(ours[:, 0] == 0.0)


def test_cross_mode_matches_sklearn(rng):
    q = rng.normal(size=(300, 4))
    r = rng.normal(size=(450, 4))
    ours = exact_knn(q, r, 5, engine="xla")
    sk = _sk_dist(q, r, 5)
    np.testing.assert_allclose(ours, sk, rtol=0, atol=1e-9)


def test_large_offset_precision(rng):
    # Un-centered data with large coordinate offsets is the f32 killer
    # (catastrophic cancellation in the matmul identity); the refine path
    # must still match sklearn/f64.
    x = rng.normal(size=(400, 6)) + np.array([1e4, -2e4, 3e4, 0.5, -1e3, 7e3])
    ours = exact_knn(x, None, 4, engine="xla")
    sk = _sk_dist(x, x, 4)
    np.testing.assert_allclose(ours, sk, rtol=1e-12, atol=1e-9)


def test_fast_mode_close(rng):
    x = rng.normal(size=(400, 5)).astype(np.float64)
    fast = exact_knn(x, None, 4, refine=False, engine="xla")
    sk = _sk_dist(x, x, 4)
    np.testing.assert_allclose(fast, sk, rtol=1e-4, atol=1e-4)


def test_block_boundaries(rng):
    # ref size not a multiple of the block: padded rows must never win
    q = rng.normal(size=(50, 3))
    r = rng.normal(size=(130, 3))
    d2, idx = knn_select_xla(np.float32(q), np.float32(r), 5, block_size=64)
    assert np.all(np.asarray(idx) >= 0)
    assert np.all(np.asarray(idx) < 130)
    sk = _sk_dist(q, r, 5)
    np.testing.assert_allclose(np.sqrt(np.asarray(d2)), sk, rtol=1e-4, atol=1e-4)


def test_k_larger_than_ref(rng):
    q = rng.normal(size=(10, 3))
    r = rng.normal(size=(4, 3))
    out = exact_knn(q, r, 8, engine="xla")   # k clamped to |ref|
    assert out.shape == (10, 4)


def test_refine_handles_padding_sentinels(rng):
    q = rng.normal(size=(6, 2))
    r = rng.normal(size=(8, 2))
    idx = np.tile(np.arange(8), (6, 1))
    idx = np.concatenate([idx, np.full((6, 1), -1)], axis=1)
    # -1 sentinel column: must sort to the end, not crash
    d = refine_knn_f64(q, r, idx, 7)
    assert np.all(np.isfinite(d))
    sk = _sk_dist(q, r, 7)
    np.testing.assert_allclose(d, sk, atol=1e-12)


def test_duplicate_points(rng):
    # duplicated samples: multiple zero distances in self mode
    x = rng.normal(size=(20, 3))
    x[5] = x[3]
    ours = exact_knn(x, None, 3, engine="xla")
    sk = _sk_dist(x, x, 3)
    np.testing.assert_allclose(np.sort(ours, axis=1), np.sort(sk, axis=1),
                               atol=1e-9)
    assert ours[3, 1] == 0.0 and ours[5, 1] == 0.0


def test_bucket_size_properties():
    from mcevidence_tpu.ops.knn import bucket_size
    import math
    for n in [1, 100, 512, 513, 1000, 26862, 28418, 46313, 99999, 1 << 20]:
        b = bucket_size(n)
        assert b >= n
        assert b <= max(512, math.ceil(1.25 * n))   # <=25% overpad
        assert b % 128 == 0
    # buckets collapse nearby sizes to one compile shape
    assert bucket_size(26862) == bucket_size(28418)


def test_exact_knn_candidate_guard_on_near_ties(rng, caplog):
    # points on a shell whose radial gaps (~1e-8 relative) are far below the
    # f32 ranking noise: the sufficiency guard must detect the thin margin
    # and re-select with more candidates (ADVICE r1: pad_candidates trust)
    import logging

    from mcevidence_tpu.ops.knn import exact_knn
    n, d = 800, 4
    dirs = rng.normal(size=(n, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = 1.0 + 1e-8 * rng.random(n)
    ref = dirs * radii[:, None]
    q = np.zeros((3, d))
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu.ops.knn"):
        dk = exact_knn(q, ref, 3, refine=True, engine="xla", bucket=False)
    assert any("re-selecting" in r.message for r in caplog.records)
    # even with unresolvable f32 ties the refined result is within the tie
    # gap of the true distances
    from sklearn.neighbors import NearestNeighbors
    sk_d, _ = NearestNeighbors(n_neighbors=3).fit(ref).kneighbors(q)
    np.testing.assert_allclose(dk, sk_d, rtol=1e-7)


def test_exact_knn_guard_quiet_on_normal_data(rng, caplog):
    import logging

    from mcevidence_tpu.ops.knn import exact_knn
    x = rng.normal(size=(500, 4))
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu.ops.knn"):
        exact_knn(x, None, 4, refine=True, engine="xla", bucket=False)
    assert not any("re-selecting" in r.message for r in caplog.records)


def test_xla_nonzero_padding_beyond_nr(rng):
    """REGRESSION (round-4 review): knn_select_xla shares the kernel
    wrapper's nr contract (rows beyond nr are only 'never selected'), so
    its centring mean must exclude them too — garbage padding used to
    shift mu by the padding magnitude and corrupt every f32-centred
    coordinate."""
    import jax.numpy as jnp
    r = rng.normal(size=(300, 4)).astype(np.float32)
    q = r[:64]
    garbage = np.full((100, 4), 1e8, np.float32)
    r_pad = np.concatenate([r, garbage])
    want_d2, want_idx = knn_select_xla(jnp.asarray(q), jnp.asarray(r), 4)
    d2, idx = knn_select_xla(jnp.asarray(q), jnp.asarray(r_pad), 4, nr=300)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_idx))
    np.testing.assert_allclose(np.asarray(d2), np.asarray(want_d2),
                               rtol=4e-4, atol=2e-6)

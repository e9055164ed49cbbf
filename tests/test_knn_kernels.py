"""Every kNN selection engine against the float64 ground truth, and the one
place that picks the engine.

The Triton-route kernel runs in Pallas interpret mode here (no GPU); its
compiled form is checked on the card by chip_smoke.py's kernel phase."""

import functools
import logging

import numpy as np
import pytest
from sklearn.neighbors import NearestNeighbors

import jax
import jax.numpy as jnp

from mcevidence_tpu.ops import knn
from mcevidence_tpu.ops.knn_triton import (knn_select_triton,
                                           knn_select_triton_batched)


def _xla_batched(q, r, k, self_mode=False, nr=None):
    return jax.vmap(lambda a, b, n: knn.knn_select_xla(
        a, b, k, self_mode=self_mode, nr=n))(q, r, nr)


SELECT = {
    "xla": knn.knn_select_xla,
    "triton": functools.partial(knn_select_triton, interpret=True),
}
SELECT_BATCHED = {
    "xla": _xla_batched,
    "triton": functools.partial(knn_select_triton_batched, interpret=True),
}
ENGINES = sorted(SELECT)


def _sel(engine, q, r, k, **kw):
    d2, idx = SELECT[engine](jnp.asarray(q), jnp.asarray(r), k, **kw)
    return np.asarray(d2), np.asarray(idx)


def _f64_dist_at(query, ref, idx):
    """f64 distances at the returned indices, sorted (absent slots +inf)."""
    q = np.asarray(query, np.float64)
    r = np.asarray(ref, np.float64)
    d2 = np.sum((q[:, None, :] - r[np.maximum(idx, 0)]) ** 2, axis=-1)
    return np.sqrt(np.sort(np.where(idx < 0, np.inf, d2), axis=1))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n,d,k", [(300, 5, 6), (517, 3, 4), (517, 8, 4)])
def test_self_mode(rng, engine, n, d, k):
    x = rng.normal(size=(n, d)).astype(np.float32)
    d2, idx = _sel(engine, x, x, k, self_mode=True)
    sk_d, sk_i = NearestNeighbors(n_neighbors=k).fit(x).kneighbors(x)
    assert np.all(idx[:, 0] == np.arange(n))
    assert np.all(d2[:, 0] == 0.0)
    np.testing.assert_array_equal(np.sort(idx, axis=1), np.sort(sk_i, axis=1))
    np.testing.assert_allclose(np.sqrt(d2), sk_d, atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
def test_cross_mode(rng, engine):
    q = rng.normal(size=(130, 4)).astype(np.float32)
    r = rng.normal(size=(1030, 4)).astype(np.float32)   # uneven ref tiles
    d2, idx = _sel(engine, q, r, 5)
    assert np.all(idx >= 0) and np.all(idx < 1030)
    sk_d, sk_i = NearestNeighbors(n_neighbors=5).fit(r).kneighbors(q)
    np.testing.assert_array_equal(np.sort(idx, axis=1), np.sort(sk_i, axis=1))
    np.testing.assert_allclose(np.sqrt(d2), sk_d, atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
def test_runtime_nr(rng, engine):
    # rows beyond the runtime count are padding and never selected
    q = rng.normal(size=(130, 4)).astype(np.float32)
    r = rng.normal(size=(1030, 4)).astype(np.float32)
    d2, idx = _sel(engine, q, r, 5, nr=730)
    assert np.all(idx >= 0) and np.all(idx < 730)
    sk_d, sk_i = NearestNeighbors(n_neighbors=5).fit(r[:730]).kneighbors(q)
    np.testing.assert_array_equal(np.sort(idx, axis=1), np.sort(sk_i, axis=1))
    np.testing.assert_allclose(np.sqrt(d2), sk_d, atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
def test_nonzero_padding_beyond_nr(rng, engine):
    """The centring mean must exclude rows beyond nr: garbage padding would
    otherwise shift it by ~1e8 and wreck every f32 coordinate."""
    r = rng.normal(size=(300, 4)).astype(np.float32)
    q = r[:64]
    r_pad = np.concatenate([r, np.full((100, 4), 1e8, np.float32)])
    want_d2, want_idx = _sel(engine, q, r, 4)
    d2, idx = _sel(engine, q, r_pad, 4, nr=300)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(d2, want_d2, rtol=4e-4, atol=2e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_absent_slots_return_minus_one(rng, engine):
    """With fewer than k real reference rows the extra slots decode to
    (+inf, -1) — never stale duplicates a refine stage would double-count."""
    nr, k = 3, 5
    q = rng.normal(size=(8, 4)).astype(np.float32)
    r_pad = np.zeros((700, 4), np.float32)
    r_pad[:nr] = rng.normal(size=(nr, 4))
    d2, idx = _sel(engine, q, r_pad, k, nr=nr)
    assert np.all(idx[:, nr:] == -1)
    assert np.all(np.isinf(d2[:, nr:]))
    want = NearestNeighbors(n_neighbors=nr).fit(r_pad[:nr]).kneighbors(q)[1]
    np.testing.assert_array_equal(np.sort(idx[:, :nr], axis=1),
                                  np.sort(want, axis=1))


@pytest.mark.parametrize("engine", ENGINES)
def test_high_k(rng, engine):
    """The largest candidate count each engine serves (the kernel's register
    limit; the xla engine takes the guard's k=26 re-selection)."""
    k = knn.KERNEL_MAX_K if engine == "triton" else 26
    n, d = 700, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    d2, idx = _sel(engine, x, x, k, self_mode=True)
    sk_d, _ = NearestNeighbors(n_neighbors=k).fit(x).kneighbors(x)
    assert np.all(idx[:, 0] == np.arange(n))
    np.testing.assert_allclose(_f64_dist_at(x, x, idx), sk_d, rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(np.sqrt(d2), sk_d, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
def test_batched_matches_single(rng, engine):
    """Per-member runtime counts; every member matches its own single-cell
    selection and sklearn on its valid rows."""
    ns = [400, 311, 287]
    batch = np.zeros((3, 400, 5), np.float32)
    for b, n in enumerate(ns):
        batch[b, :n] = rng.normal(size=(n, 5))
    d2b, idxb = SELECT_BATCHED[engine](
        jnp.asarray(batch), jnp.asarray(batch), 4, self_mode=True,
        nr=jnp.asarray(ns, jnp.int32))
    d2b, idxb = np.asarray(d2b), np.asarray(idxb)
    for b, n in enumerate(ns):
        d2s, idxs = _sel(engine, batch[b], batch[b], 4, self_mode=True, nr=n)
        np.testing.assert_array_equal(idxb[b, :n], idxs[:n])
        np.testing.assert_allclose(d2b[b, :n], d2s[:n], rtol=1e-6)
        sk_d, _ = NearestNeighbors(n_neighbors=4).fit(
            batch[b, :n]).kneighbors(batch[b, :n])
        np.testing.assert_allclose(_f64_dist_at(
            batch[b, :n], batch[b, :n], idxb[b, :n]), sk_d, rtol=1e-6,
            atol=1e-4)


def test_triton_wrapper_pads_to_its_tiles(rng):
    """Row counts off the tile grid and d off the 16-column quantum: the
    wrapper pads both and slices back to the caller's shapes."""
    q = rng.normal(size=(70, 3)).astype(np.float32)
    r = rng.normal(size=(129, 3)).astype(np.float32)
    d2, idx = _sel("triton", q, r, 3)
    assert d2.shape == idx.shape == (70, 3)
    np.testing.assert_array_equal(idx, _sel("xla", q, r, 3)[1])


def test_triton_rejects_k_beyond_registers(rng):
    x = jnp.asarray(rng.normal(size=(64, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="KERNEL_MAX_K"):
        knn_select_triton(x, x, knn.KERNEL_MAX_K + 1, interpret=True)


# ---------------------------------------------------------------------------
# the engine picker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform,engine", [("cpu", "xla"),
                                             ("gpu", "triton")])
def test_select_engine_by_platform(monkeypatch, platform, engine):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert knn.select_engine("auto") == engine
    assert knn.select_engine("xla") == "xla"


def test_select_engine_refuses_other_platforms(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="no kNN engine"):
        knn.select_engine("auto")


def test_kernel_routes_large_k_to_xla(monkeypatch, rng, caplog):
    """Above KERNEL_MAX_K the dispatcher takes knn_select_xla, with a log
    line; at or below it the kernel."""
    import mcevidence_tpu.ops.knn_triton as kt
    calls = []
    monkeypatch.setattr(kt, "knn_select_triton",
                        lambda *a, **kw: calls.append("triton") or (0, 0))
    x = jnp.asarray(rng.normal(size=(64, 4)).astype(np.float32))
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu.ops.knn"):
        d2, idx = knn.knn_select(x, x, knn.KERNEL_MAX_K + 4, self_mode=True,
                                 engine="triton")
    assert not calls and idx.shape == (64, knn.KERNEL_MAX_K + 4)
    assert any("knn_select_xla" in r.message for r in caplog.records)
    knn.knn_select(x, x, knn.KERNEL_MAX_K, engine="triton")
    assert calls == ["triton"]


REMOVED = ["pallas", "pallas_exact", "pallas_packed", "pallas_packed2",
           "pallas_binned", "pallas_smalld"]


@pytest.mark.parametrize("name", REMOVED)
def test_removed_engine_names_rejected(name, rng, tmp_path, capsys):
    """Every entry point refuses an engine name that no longer exists —
    never a silent substitute."""
    from mcevidence_tpu import cli, compare, evidence, planck
    with pytest.raises(ValueError, match="unknown engine"):
        evidence.evidence_fn(rng.normal(size=(50, 2)), np.zeros(50),
                             engine=name)
    with pytest.raises(ValueError, match="unknown kNN engine"):
        knn.select_engine(name)
    for main in (cli.main, compare.main):
        with pytest.raises(SystemExit):
            main([str(tmp_path / "root"), "--engine", name])
    with pytest.raises(SystemExit):
        planck.main(["--rootdir", str(tmp_path), "--engine", name])
    assert "invalid choice" in capsys.readouterr().err

"""Batch-plan semantics (reference set_batch, MCEvidence.py:797-840)."""

import numpy as np
import pytest

from mcevidence_tpu.utils.batch import get_batch_range, make_batch_plan


def test_default_single_batch():
    plan = make_batch_plan([1000], nbatch=1, brange=None)
    np.testing.assert_array_equal(plan.batch_sizes_s1(), [1000])
    assert plan.bsize is None
    np.testing.assert_allclose(plan.powers[0, 0], 3.0)


def test_logpower():
    plan = make_batch_plan([100000], nbatch=3, brange=[2, 4],
                           bscale="logpower")
    np.testing.assert_array_equal(plan.batch_sizes_s1(), [100, 1000, 10000])
    np.testing.assert_allclose(plan.powers[:, 0], [2, 3, 4])


def test_linear():
    plan = make_batch_plan([5000], nbatch=3, brange=[100, 300],
                           bscale="linear")
    np.testing.assert_array_equal(plan.batch_sizes_s1(), [100, 200, 300])


def test_constant_cumsum():
    # 'constant': bsize = brange everywhere, analysed counts are the cumsum
    # (growing prefixes; reference MCEvidence.py:836-840)
    plan = make_batch_plan([5000], nbatch=3, brange=200, bscale="ignored")
    np.testing.assert_array_equal(plan.bsize[:, 0], [200, 200, 200])
    np.testing.assert_array_equal(plan.batch_sizes_s1(), [200, 400, 600])
    np.testing.assert_array_equal(plan.powers[:, 0], [0, 1, 2])


def test_int_brange_forces_constant():
    # reference MCEvidence.py:680: integer brange coerces bscale='constant'
    plan = make_batch_plan([5000], nbatch=2, brange=100, bscale="logpower")
    np.testing.assert_array_equal(plan.batch_sizes_s1(), [100, 200])


def test_zero_range_multiple_batches_rejected():
    with pytest.raises(ValueError, match="batch range"):
        make_batch_plan([5000], nbatch=3, brange=[3, 3], bscale="logpower")


def test_get_batch_range():
    assert get_batch_range([4, 2]) == (2.0, 4.0)


def test_two_partitions_split():
    plan = make_batch_plan([600, 400], nbatch=1, brange=None)
    np.testing.assert_array_equal(plan.nchain[0], [600, 400])


def test_facade_constant_bscale(rng):
    from mcevidence_tpu import MCEvidence
    from tests.conftest import make_gaussian_chain
    theta, lnl = make_gaussian_chain(rng, n=1500, ndim=3)
    mce = MCEvidence({"samples": theta, "loglikes": lnl}, kmax=2, verbose=0,
                     nbatch=2, brange=300, engine="xla")
    assert mce.bscale == "constant"
    out = mce.evidence()
    assert out.shape == (2, 1)
    assert np.all(np.isfinite(out))


def test_compile_shape_audit_records_buckets():
    """Same-bucket dispatches record one shape; distinct buckets add more."""
    import numpy as np
    from mcevidence_tpu.ops.pipeline import device_refine_evidence
    from mcevidence_tpu.utils.cache import reset_shape_log, shape_report

    rng = np.random.default_rng(0)
    reset_shape_log()

    def run(n):
        th = rng.normal(size=(n, 3))
        lnl = -0.5 * np.sum(th * th, axis=1)
        device_refine_evidence(th, lnl, kmax=2, engine="xla")

    run(900)
    run(950)        # same power-of-two bucket -> no new shape
    n1 = len(shape_report())
    run(3000)       # new bucket
    n2 = len(shape_report())
    assert n1 == 1 and n2 == 2, shape_report()


def test_compilation_cache_withdrawn_on_cpu_fallback(monkeypatch):
    """On the CPU backend no persistent cache is set up: a cached CPU
    executable can carry machine features another host lacks."""
    import jax

    from mcevidence_tpu.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        cache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compilation_cache_default_is_fixed_checkout_path(monkeypatch):
    """On an accelerator with JAX_COMPILATION_CACHE_DIR unset the cache
    goes to <checkout>/.jax_cache, a path git ignores."""
    import os

    import jax

    from mcevidence_tpu.utils import cache
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.CACHE_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        cache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == cache.CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compilation_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR decides the location: JAX reads it itself
    and the code sets nothing over it."""
    import jax

    from mcevidence_tpu.utils import cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", str(tmp_path / "cc"))
        cache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_ranged_plans_never_emit_zero_size():
    """A 0 in a ranged plan would read downstream as 'full partition'
    (_get_batch's nsamples<=0 sentinel), mislabelling a full-chain lnZ as
    the smallest convergence-curve point — clamp to 1 instead."""
    from mcevidence_tpu.utils.batch import make_batch_plan
    plan = make_batch_plan([10000], nbatch=3, brange=(0, 1000),
                           bscale="linear")
    assert plan.bsize.min() >= 1
    assert plan.nchain.min() >= 1
    plan = make_batch_plan([10000], nbatch=3, brange=(-1, 3),
                           bscale="logpower")
    assert plan.bsize.min() >= 1


def test_constant_branch_shape_error():
    """A (min, max) brange with the default bscale must raise a usable
    message pointing at bscale, not a numpy broadcast traceback."""
    import pytest

    from mcevidence_tpu.utils.batch import make_batch_plan
    with pytest.raises(ValueError, match="logpower"):
        make_batch_plan([10000], nbatch=3, brange=(50, 5000))
    # scalar and per-partition constants still work
    plan = make_batch_plan([100, 200], nbatch=2, brange=(30, 40))
    assert plan.bsize.tolist() == [[30, 40], [30, 40]]

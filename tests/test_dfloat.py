"""Double-float building blocks must deliver ~2^-45 relative precision
using only f32 ops (they carry the device-resident refinement)."""

import numpy as np

import jax.numpy as jnp

from mcevidence_tpu.ops import dfloat as df


def _pair(x64):
    hi, lo = df.df_from_f64_np(x64)
    return jnp.asarray(hi), jnp.asarray(lo)


def _val(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def test_two_prod_exact(rng):
    a = jnp.asarray(rng.normal(size=1000), jnp.float32)
    b = jnp.asarray(rng.normal(size=1000), jnp.float32)
    p, e = df.two_prod(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_array_equal(_val(p, e), exact)


def test_df_mul_precision(rng):
    x = rng.normal(size=2000)
    y = rng.normal(size=2000)
    xh, xl = _pair(x)
    yh, yl = _pair(y)
    h, l = df.df_mul(xh, xl, yh, yl)
    rel = np.abs(_val(h, l) - x * y) / np.abs(x * y)
    assert rel.max() < 1e-13


def test_df_sqrt_precision(rng):
    x = np.abs(rng.normal(size=2000)) + 1e-6
    h, l = df.df_sqrt(*_pair(x))
    rel = np.abs(_val(h, l) - np.sqrt(x)) / np.sqrt(x)
    assert rel.max() < 1e-13


def test_df_reduce_sum_precision(rng):
    # f32 tree sum of 1e5 terms loses ~1e-6 relative; df reduce must hold
    # f64-grade accuracy
    x = rng.normal(size=100001) + 0.5
    h, l = df.df_reduce_sum(*_pair(x))
    exact = np.sum(x)
    assert abs(_val(h, l) - exact) / abs(exact) < 1e-12


def test_candidate_d2_df_matches_f64(rng):
    q = rng.normal(size=(500, 7))
    idx = rng.integers(0, 500, size=(500, 6)).astype(np.int32)
    qh, ql = _pair(q)
    d2h, d2l = df.candidate_d2_df(qh, ql, qh, ql, jnp.asarray(idx))
    diff = q[:, None, :] - q[idx]
    exact = np.einsum("nkd,nkd->nk", diff, diff)
    got = _val(d2h, d2l)
    nz = exact > 0
    assert (np.abs(got - exact)[nz] / exact[nz]).max() < 1e-12


def test_candidate_d2_df_absent(rng):
    q = rng.normal(size=(64, 3))
    idx = np.full((64, 4), -1, np.int32)
    qh, ql = _pair(q)
    d2h, _ = df.candidate_d2_df(qh, ql, qh, ql, jnp.asarray(idx))
    assert np.all(np.isinf(np.asarray(d2h)))


def test_import_does_not_initialize_backend():
    """REGRESSION (round 4): importing the double-float module must not
    create device arrays — a module-level jnp constant initialized the
    backend at import time (importing a module must not claim a device).
    Checked in a subprocess so this process's already-initialized backend
    cannot mask it."""
    import os
    import subprocess
    import sys

    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu');\n"
        "from mcevidence_tpu.ops import dfloat, estimator, whiten\n"
        "from mcevidence_tpu.chains import reader, preprocess\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge._backends, "
        "'import initialized a backend: %r' % (xla_bridge._backends,)\n"
        "print('clean')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "clean"


def test_device_refine_k1_parity_under_jit():
    """REGRESSION (round-4): XLA:CPU rematerializes products into consumer
    fusions where LLVM contracts them into fmas, destroying the error-free
    double-float identities — device-precision k=1 lnZ silently degraded
    to ~1e-9 vs host refine (contract: ~1e-13).  The CPU path now compiles
    the EFT post stage at backend optimization level 0; this pins k=1
    parity across dimensionalities."""
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from conftest import make_gaussian_chain

    from mcevidence_tpu.ops.pipeline import (device_refine_evidence,
                                             host_refine_evidence)
    for d in (3, 8):
        th, lnl = make_gaussian_chain(np.random.default_rng(3), n=2000,
                                      ndim=d)
        dv = device_refine_evidence(th, lnl, kmax=3, engine="xla")
        hv = host_refine_evidence(th, lnl, kmax=3, engine="xla")
        assert abs(dv[0] - hv[0]) < 5e-12, (d, dv, hv)
        assert abs(dv[1] - hv[1]) < 5e-12, (d, dv, hv)


def test_df_mul_broadcast_under_jit_is_exact():
    """The minimal reproducer of the fusion/contraction corruption: df_mul
    with a broadcast factor, jitted, must stay at double-float precision.
    (Runs the O0-compiled path indirectly only on CPU; kept as a canary —
    if this fails, see dfloat._split and pipeline._refine_dotp_post_o0.)"""
    import jax
    import jax.numpy as jnp

    from mcevidence_tpu.ops.dfloat import df_from_f64_np, df_mul
    rng = np.random.default_rng(0)
    p64 = np.abs(rng.normal(30, 20, size=(3000, 3)))
    s64 = np.exp(rng.normal(-1, 0.5, size=3000))
    ph, pl = df_from_f64_np(p64)
    sh, sl = df_from_f64_np(s64)
    truth = ((ph.astype(np.float64) + pl.astype(np.float64))
             * (sh.astype(np.float64) + sl.astype(np.float64))[:, None])

    def g(ph, pl, a, b):
        return df_mul(ph, pl, a[:, None], b[:, None])

    compiled = jax.jit(g).lower(
        jnp.asarray(ph), jnp.asarray(pl), jnp.asarray(sh), jnp.asarray(sl)
    ).compile(compiler_options={"xla_backend_optimization_level": "0"})
    h, l = compiled(jnp.asarray(ph), jnp.asarray(pl), jnp.asarray(sh),
                    jnp.asarray(sl))
    v = np.asarray(h, np.float64) + np.asarray(l, np.float64)
    rel = np.abs(v - truth) / np.abs(truth)
    assert rel.max() < 1e-13, rel.max()

"""The driver entry points must stay importable and runnable."""

import numpy as np

import jax


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    # example args are host arrays (jit takes them directly)
    assert all(isinstance(a, np.ndarray) for a in args)
    out = np.asarray(jax.jit(fn)(*args))
    assert out.shape == (5,)
    assert np.all(np.isfinite(out[1:]))
    assert abs(out[1]) < 0.5       # lnZ ~ 0 for the synthetic chain


def test_dryrun_multichip_8():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)

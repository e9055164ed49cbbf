"""chip_smoke.py's own pieces that run without a card: its independent
float64 reference, and its refusal to run anywhere but on a GPU."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_reference_matches_host_refine_auto():
    from mcevidence_tpu.ops.pipeline import host_refine_evidence
    theta, lnl, w, _, _ = chip_smoke.make_chain(2000, 6, seed=3)
    want = host_refine_evidence(theta, lnl, w, kmax=4, prior_volume=2.5,
                                engine="xla")
    got = chip_smoke.reference_lnz(theta, lnl, w, 4, prior_volume=2.5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_reference_matches_host_refine_cross_with_sumw():
    from mcevidence_tpu.ops.pipeline import host_refine_evidence
    theta, lnl, w, _, _ = chip_smoke.make_chain(1500, 5, seed=4)
    s1, s2 = theta[:800], theta[800:]
    want = host_refine_evidence(s1, lnl[:800], w[:800], samples2=s2, kmax=3,
                                sum_adjusted_weights=700.0, engine="xla")
    got = chip_smoke.reference_lnz(s1, lnl[:800], w[:800], 3, s2=s2,
                                   sumw=700.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_chip_smoke_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr
    for line in p.stdout.splitlines():
        assert '"ok"' not in line

"""Test configuration: fake 8-device CPU mesh.

Multi-device sharding is validated on a virtual CPU mesh (SURVEY.md §4e) —
the substitute for "multi-node without a real cluster".  The env vars must
be set before jax initializes, hence this module-level block.
"""

import os

# Force CPU even when the environment presets JAX_PLATFORMS.  The
# unit/parity suite runs on the virtual 8-device CPU mesh; GPU execution
# is exercised by chip_smoke.py and bench.py instead.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def make_gaussian_chain(rng, n=2000, ndim=4, sigma=0.05):
    """Synthetic chain sampled exactly from its own Gaussian likelihood
    (examples.py:267-342 equivalent): lnZ -> -ln(V_prior) as n grows."""
    mean = np.arange(1.0, ndim + 1.0)
    sig = np.full(ndim, sigma)
    theta = rng.normal(mean, sig, size=(n, ndim))
    dm = (theta - mean) / sig
    lnl = (-0.5 * np.sum(dm * dm, axis=1)
           - 0.5 * ndim * np.log(2 * np.pi) - np.sum(np.log(sig)))
    return theta, lnl


@pytest.fixture
def gaussian_chain(rng):
    return make_gaussian_chain(rng)

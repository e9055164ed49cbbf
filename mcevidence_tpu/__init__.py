"""mcevidence_tpu — Bayesian evidence estimation from MCMC chains on a GPU.

A from-scratch JAX/XLA/Pallas implementation of the Heavens et al. (2017,
arXiv:1704.03472) kNN marginal-likelihood estimator with the full capability
surface of the reference MCEvidence package: chain ingestion (CosmoMC /
MontePython / Cobaya / emcee-HDF5 / MultiNest / PolyChord / UltraNest /
dynesty / ArviZ), burn-in, three thinning algorithms, auto- and
cross-evidence, importance reweighting, prior volumes, CLI, a resident
JSON-lines service, and the Planck full-grid batch driver — with the
O(N^2 d) nearest-neighbour sweep running on the accelerator (a fused
Pallas kernel on the GPU) and scaling across devices via a ring of
shards.
"""

from ._version import __version__
from .compat import MCSamples, split_var
from .evidence import (MCEvidence, evidence_bootstrap, evidence_fn,
                       evidence_with_error)
from .chains.nested import load_nested_chains, sampler_lnz
from .registry import COSMO_PARAMS, extend_cosmo_params, iscosmo_param
from .priors.params_info import get_prior_volume, params_info
from .samplers import nuts_sample, stretch_sample

# reference-compatible module-level alias (reference MCEvidence.py:84-86)
cosmo_params_list = list(COSMO_PARAMS)


def __getattr__(name):
    # lazy: eager `from .compare import ...` would trip runpy's
    # double-import warning for `python -m mcevidence_tpu.compare`
    if name == "compare_models":
        from .compare import compare_models
        return compare_models
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "MCEvidence",
    "MCSamples",
    "split_var",
    "evidence_fn",
    "evidence_with_error",
    "evidence_bootstrap",
    "compare_models",
    "nuts_sample",
    "stretch_sample",
    "load_nested_chains",
    "sampler_lnz",
    "COSMO_PARAMS",
    "cosmo_params_list",
    "extend_cosmo_params",
    "iscosmo_param",
    "get_prior_volume",
    "params_info",
    "__version__",
]

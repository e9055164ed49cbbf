"""Cobaya chain ingestion (no reference counterpart).

Cobaya (github.com/CobayaSampler/cobaya) is the successor to CosmoMC; its
products for a run rooted at ``<root>`` are ``<root>.<i>.txt`` chain files
(one per MPI process, CosmoMC-like whitespace tables with a ``#`` header
line naming every column) plus ``<root>.updated.yaml``, the fully resolved
run config.  The reference framework predates Cobaya and only reads
CosmoMC/MontePython products (reference MCEvidence.py:560-606,1204-1272);
this module maps Cobaya products onto the same internal contract:

* chain columns ``weight  minuslogpost  <params...>  minuslogprior...
  chi2...`` become ``[weight, -lnL, sampled params...]`` — the per-sample
  -lnL is ``chi2/2`` (Cobaya's ``chi2`` column is the total
  -2 ln L), falling back to ``minuslogpost - minuslogprior`` when a run
  was configured without the aggregated chi2 column;
* sampled (non-derived, non-fixed) parameters and their uniform prior
  bounds come from ``updated.yaml``'s ``params`` block, giving the prior
  volume the evidence normalizes by.  Non-uniform priors have no finite
  flat volume — computing one raises, matching the MontePython
  unbounded-prior behaviour (use ``-pv`` / ``priorvolume=`` instead).
"""

from __future__ import annotations

import glob as _glob
import logging
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def updated_yaml_path(root: str) -> Optional[str]:
    """``<root>.updated.yaml`` (``root`` may already carry the
    ``.updated.yaml``/``.updated.yml`` suffix)."""
    if root.endswith((".updated.yaml", ".updated.yml")):
        return root if os.path.isfile(root) else None
    for suffix in (".updated.yaml", ".updated.yml"):
        p = root + suffix
        if os.path.isfile(p):
            return p
    return None


def is_cobaya_root(root: str) -> bool:
    return updated_yaml_path(root) is not None


def _strip_yaml_suffix(root: str) -> str:
    for suffix in (".updated.yaml", ".updated.yml"):
        if root.endswith(suffix):
            return root[: -len(suffix)]
    return root


def sampled_params(root: str) -> Dict[str, Optional[Tuple[float, float]]]:
    """Sampled-parameter name -> (min, max) bounds, or None when the prior
    is not a bounded uniform (norm etc. — no finite flat volume).

    Cobaya ``params`` entries: a dict with a ``prior`` key is sampled; a
    bare number is fixed; anything else (latex-only dicts, ``derived:``
    strings/lambdas) is derived.  Uniform priors spell bounds either as
    ``{min: a, max: b}`` or ``{dist: uniform, loc: a, scale: w}``
    (= [a, a+w]).
    """
    path = updated_yaml_path(root)
    if path is None:
        raise FileNotFoundError(f"no Cobaya updated.yaml for root {root!r}")
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading the Cobaya file {path} needs the "
                          "'pyyaml' package, which is not installed") from e
    with open(path, "r") as fp:
        cfg = yaml.safe_load(fp)
    params = (cfg or {}).get("params") or {}
    out: Dict[str, Optional[Tuple[float, float]]] = {}
    for name, spec in params.items():
        if not isinstance(spec, dict) or "prior" not in spec:
            continue
        if spec.get("derived"):
            continue
        prior = spec["prior"]
        bounds: Optional[Tuple[float, float]] = None
        if isinstance(prior, (list, tuple)) and len(prior) == 2:
            bounds = (float(prior[0]), float(prior[1]))
        elif isinstance(prior, dict):
            # only dist: uniform (the default) carries a flat volume —
            # min/max on a loguniform/norm/... prior must NOT silently
            # become a uniform range (round-4 review: the documented
            # non-uniform-prior rejection was bypassed)
            dist = prior.get("dist", "uniform")
            if dist == "uniform":
                if "min" in prior or "max" in prior:
                    bounds = (float(prior.get("min", 0.0)),
                              float(prior.get("max", 1.0)))
                else:
                    loc = float(prior.get("loc", 0.0))
                    scale = float(prior.get("scale", 1.0))
                    bounds = (loc, loc + scale)
        out[str(name)] = bounds
    if not out:
        raise ValueError(f"Cobaya config {path} declares no sampled "
                         "parameters")
    return out


def ordered_sampled_params(root: str) -> Dict[str, Optional[Tuple[float,
                                                                  float]]]:
    """``sampled_params`` reordered with registry-cosmological names FIRST
    (each block in updated.yaml order).

    This ordering is the contract between the chain loader and the prior
    metadata: ``MCEvidence`` integrates over the first ``ndim`` parameter
    COLUMNS (evidence.py:229), so when the cosmo-name filter keeps a
    subset of the sampled parameters, that subset must be exactly the
    leading columns of what ``load_cobaya_chains`` emits — otherwise the
    volume and the integrated coordinates silently disagree."""
    from ..registry import iscosmo_param
    spec = sampled_params(root)
    cosmo = {n: b for n, b in spec.items() if iscosmo_param(n)}
    rest = {n: b for n, b in spec.items() if n not in cosmo}
    return {**cosmo, **rest}


def resolve_cobaya_files(root: str, idchain: int = 0) -> List[str]:
    """``<root>.<i>.txt`` chain files in sorted order (``idchain`` > 0
    selects one, mirroring the CosmoMC ``root_<id>.txt`` semantics)."""
    root = _strip_yaml_suffix(root)
    if idchain > 0:
        flist = [f"{root}.{idchain}.txt"]
        if not os.path.isfile(flist[0]):
            raise FileNotFoundError(f"no Cobaya chain file {flist[0]!r}")
        return flist
    pattern = re.compile(re.escape(os.path.basename(root)) + r"\.\d+\.txt$")
    # glob.escape: run directories may contain glob metacharacters ([?*)
    flist = sorted(f for f in _glob.glob(_glob.escape(root) + ".*.txt")
                   if pattern.match(os.path.basename(f)))
    if not flist:
        raise FileNotFoundError(f"no Cobaya chain files match {root}.N.txt")
    return flist


def _header_names(path: str) -> List[str]:
    with open(path, "r") as fp:
        first = fp.readline()
    if not first.startswith("#"):
        raise ValueError(f"Cobaya chain {path} has no '#' header line")
    return first[1:].split()


def load_cobaya_chains(root: str, idchain: int = 0) -> List[np.ndarray]:
    """Per-chain ``[weight, -lnL, sampled params...]`` column matrices."""
    from .reader import parse_chain_file
    names = list(ordered_sampled_params(root).keys())   # cosmo names first
    flist = resolve_cobaya_files(root, idchain=idchain)
    logger.info("reading Cobaya chain files: %s", ", ".join(flist))
    out = []
    for f in flist:
        header = _header_names(f)
        col = {n: i for i, n in enumerate(header)}
        missing = [n for n in names if n not in col]
        if missing:
            raise ValueError(f"Cobaya chain {f} is missing sampled-parameter "
                             f"columns {missing} (header: {header})")
        arr = parse_chain_file(f)
        if arr.shape[1] != len(header):
            raise ValueError(f"Cobaya chain {f}: header names {len(header)} "
                             f"columns, file has {arr.shape[1]}")
        if "chi2" in col:
            neg_lnl = 0.5 * arr[:, col["chi2"]]
        elif "minuslogpost" in col and "minuslogprior" in col:
            neg_lnl = arr[:, col["minuslogpost"]] - arr[:, col["minuslogprior"]]
        else:
            raise ValueError(
                f"Cobaya chain {f} has neither a 'chi2' nor "
                "'minuslogpost'+'minuslogprior' columns; cannot recover lnL")
        w = arr[:, col["weight"]] if "weight" in col else np.ones(len(arr))
        theta = arr[:, [col[n] for n in names]]
        out.append(np.column_stack([w, neg_lnl, theta]))
    return out


def cobaya_params_info(root: str, cosmo: bool = False):
    """``ParamsInfo`` over the sampled parameters of a Cobaya run.

    ``cosmo=True`` applies the CosmoMC-name registry filter like the
    ``.ranges`` path does; Cobaya runs typically use theory-code parameter
    names the registry does not know, so when the filter matches nothing
    every sampled parameter is kept (the sampled space IS what ln Z
    integrates over) with an info log.  ``load_cobaya_chains`` emits the
    registry-matching parameters as the LEADING columns (same ordered
    helper), so a partial match still pairs the filtered volume/ndim with
    exactly the columns the estimator integrates.
    """
    from ..priors.params_info import ParamsInfo
    from ..registry import iscosmo_param
    spec = ordered_sampled_params(root)
    if cosmo:
        filtered = {n: b for n, b in spec.items() if iscosmo_param(n)}
        if filtered:
            spec = filtered
        else:
            logger.info(
                "no sampled Cobaya parameter matches the cosmological-name "
                "registry; using all %d sampled parameters", len(spec))
    info = ParamsInfo([], [], [], [], 0)
    for name, bounds in spec.items():
        info.nr_of_params += 1
        if bounds is None:
            raise ValueError(
                f"Cobaya parameter {name!r} has a non-uniform prior: no "
                "finite flat prior volume. Pass an explicit prior volume "
                "(-pv / priorvolume=) or --unit-volume-fallback")
        vmin, vmax = bounds
        info.names.append(name)
        info.mins.append(vmin)
        info.maxs.append(vmax)
        info.ranges.append(vmax - vmin)
    return info

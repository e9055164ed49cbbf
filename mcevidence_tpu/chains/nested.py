"""Nested-sampling product ingestion: MultiNest, PolyChord, UltraNest.

The estimator's method paper (Heavens et al. 2017, arXiv:1704.03472)
positions kNN evidence from chains AGAINST nested sampling, but the
reference framework cannot read nested samplers' outputs (it only parses
CosmoMC/MontePython products, reference MCEvidence.py:560-606,1204-1272) —
so the natural cross-check "run MCEvidence on the very samples a nested
run produced and compare ln Z" required hand conversion.  This module
reads both families' posterior products directly and also parses the
sampler's OWN evidence from its stats file, so callers get the comparison
for free.

Recognized roots (``<root>`` is the sampler's output basename, e.g.
MultiNest ``chains/1-`` or PolyChord ``chains/run``):

* **MultiNest**: ``<root>.txt`` (posterior rows ``weight  -2lnL
  params...``; the weight column is the normalized posterior mass of each
  dead point), ``<root>post_equal_weights.dat`` (``params... lnL``, unit
  weights), detected via ``<root>stats.dat``.
* **PolyChord**: ``<root>.txt`` and ``<root>_equal_weights.txt`` (both in
  the same getdist posterior format ``weight  -2lnL  params...``),
  detected via ``<root>.stats``.
* **UltraNest**: a run directory (or its ``chains/`` subdir, or the file
  itself) holding ``chains/weighted_post.txt`` /
  ``chains/equal_weighted_post.txt`` — self-describing header names
  (``weight``, ``logl``, params); the run's own ln Z comes from
  ``info/results.json`` (``logz``/``logzerr``).

Either equal-weights file may also be passed as an explicit path.  The
equal-weights products are the statistically safest input: their rows ARE
(approximately) posterior draws, which is the estimator's sampling model.
The weighted ``<root>.txt`` rows are dead points whose POSITIONS follow a
flatter-than-posterior distribution; the estimator's per-point ``1/w``
weighting (reference MCEvidence.py:1117) is exactly its correction for
weighted rows, but the kNN density of heavily down-weighted tails is
noisier — prefer the equal-weights file when both exist (the automatic
root dispatch does).

``sampler_lnz(root)`` returns the nested run's own (ln Z, err) parsed
from ``<root>stats.dat`` / ``<root>.stats`` / ``info/results.json``
when present.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: suffixes tried for each family, in dispatch-preference order
_MN_EQUAL = "post_equal_weights.dat"
_PC_EQUAL = "_equal_weights.txt"
_MN_STATS = "stats.dat"
_PC_STATS = ".stats"


_UN_WEIGHTED = "weighted_post.txt"
_UN_EQUAL = "equal_weighted_post.txt"


def _ultranest_locate(root: str) -> Optional[Tuple[str, Optional[str]]]:
    """Resolve an UltraNest root to ``(dirpath, explicit)``: the directory
    holding the posterior files, and which file the caller explicitly
    named ('weighted' | 'equal' | None for a dir).  Exact basenames only —
    ``equal_weighted_post.txt`` must not be mistaken for the weighted file
    (it is a suffix of it)."""
    if os.path.isfile(root):
        base = os.path.basename(root)
        if base == _UN_WEIGHTED:
            return os.path.dirname(root), "weighted"
        if base == _UN_EQUAL:
            return os.path.dirname(root), "equal"
        return None
    if not os.path.isdir(root):
        return None
    for d in (os.path.join(root, "chains"), root):
        if (os.path.isfile(os.path.join(d, _UN_WEIGHTED))
                or os.path.isfile(os.path.join(d, _UN_EQUAL))):
            return d, None
    return None


def nested_kind(root: str) -> Optional[str]:
    """'multinest' | 'polychord' | 'ultranest' | None for a root or
    explicit product path.

    A bare ``<root>.txt`` is never claimed on its own — only the presence
    of the family's stats or equal-weights product (file names no CosmoMC/
    Cobaya run produces) marks a nested root, so ordinary chain roots are
    untouched.
    """
    if not isinstance(root, str) or not root:
        return None
    if root.endswith(_MN_EQUAL) and os.path.isfile(root):
        return "multinest"
    if root.endswith(_PC_EQUAL) and os.path.isfile(root):
        return "polychord"
    if _ultranest_locate(root) is not None:
        return "ultranest"
    # an explicit <root>.txt path is claimed only when a sibling nested
    # product exists for the same base
    base = root[:-4] if root.endswith(".txt") else root
    if os.path.isfile(base + _PC_STATS) or os.path.isfile(base + _PC_EQUAL):
        return "polychord"
    if os.path.isfile(base + _MN_STATS) or os.path.isfile(base + _MN_EQUAL):
        return "multinest"
    return None


def is_nested_root(root: str) -> bool:
    return nested_kind(root) is not None


def _strip_product_suffix(root: str) -> str:
    for suffix in (_MN_EQUAL, _PC_EQUAL, _MN_STATS, _PC_STATS, ".txt"):
        if root.endswith(suffix):
            return root[: -len(suffix)]
    return root


def _weighted_posterior_to_chain(arr: np.ndarray, path: str) -> np.ndarray:
    """getdist posterior format ``weight -2lnL params...`` ->
    ``[weight, -lnL, params...]`` (the internal CosmoMC contract)."""
    if arr.ndim != 2 or arr.shape[1] < 3:
        raise ValueError(f"nested posterior file {path} needs >= 3 columns "
                         f"(weight, -2lnL, params...); got {arr.shape}")
    w = arr[:, 0]
    neg_lnl = 0.5 * arr[:, 1]
    return np.column_stack([w, neg_lnl, arr[:, 2:]])


def _equal_weights_mn_to_chain(arr: np.ndarray, path: str) -> np.ndarray:
    """MultiNest ``post_equal_weights.dat``: ``params... lnL`` (lnL LAST,
    already +lnL, unit weights)."""
    if arr.ndim != 2 or arr.shape[1] < 2:
        raise ValueError(f"MultiNest equal-weights file {path} needs >= 2 "
                         f"columns (params..., lnL); got {arr.shape}")
    n = arr.shape[0]
    return np.column_stack([np.ones(n), -arr[:, -1], arr[:, :-1]])


def _read_header_names(path: str) -> List[str]:
    """First-line column names (UltraNest writes them with no '#' prefix;
    accept one anyway)."""
    with open(path, "r") as fp:
        first = fp.readline().strip()
    if first.startswith("#"):
        first = first[1:]
    return first.split()


def _parse_after_header(path: str) -> np.ndarray:
    """Numeric body of a header-led whitespace table (the native CosmoMC
    parser cannot skip the bare header)."""
    return np.loadtxt(path, skiprows=1, ndmin=2)


def _ultranest_parse(path: str) -> Tuple[List[str], np.ndarray]:
    names = _read_header_names(path)
    arr = _parse_after_header(path)
    if arr.shape[1] != len(names):
        raise ValueError(f"UltraNest file {path}: header names {len(names)} "
                         f"columns, file has {arr.shape[1]}")
    return names, arr


def _load_ultranest(root: str, equal_weights: Optional[bool]) -> List[np.ndarray]:
    """UltraNest run products (self-describing headers): the run dir's
    ``chains/weighted_post.txt`` (columns named in the header, including
    ``weight`` and ``logl``) and, preferred for bare roots,
    ``chains/equal_weighted_post.txt`` (unit weights; some UltraNest
    versions omit its ``logl`` column, in which case the default dispatch
    falls back to the weighted file)."""
    loc = _ultranest_locate(root)
    if loc is None:
        raise FileNotFoundError(f"no UltraNest posterior products under "
                                f"{root!r}")
    dirpath, explicit = loc
    wpath = os.path.join(dirpath, _UN_WEIGHTED)
    eq_path = os.path.join(dirpath, _UN_EQUAL)
    if explicit == "weighted" and equal_weights is not True:
        use_equal = False
    elif equal_weights is None:
        use_equal = explicit == "equal" or (os.path.isfile(eq_path)
                                            and explicit != "weighted")
    else:
        use_equal = equal_weights
    path = eq_path if use_equal else wpath
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no UltraNest product {path!r}")
    names, arr = _ultranest_parse(path)
    if "logl" not in names:
        # real UltraNest equal-weights files may carry only the parameter
        # columns; the weighted sibling always has logl
        if (use_equal and equal_weights is None and explicit is None
                and os.path.isfile(wpath)):
            logger.info("UltraNest %s has no 'logl' column; falling back "
                        "to %s", path, wpath)
            path = wpath
            names, arr = _ultranest_parse(path)
        if "logl" not in names:
            raise ValueError(f"UltraNest file {path} has no 'logl' column "
                             f"(header: {names}); cannot recover lnL")
    logger.info("reading UltraNest posterior file: %s", path)
    lnl = arr[:, names.index("logl")]
    w = (arr[:, names.index("weight")] if "weight" in names
         else np.ones(len(arr)))
    # index-based selection: duplicate header labels must not collapse
    keep = [i for i, n in enumerate(names) if n not in ("weight", "logl")]
    return [np.column_stack([w, -lnl, arr[:, keep]])]


def load_nested_chains(root: str, kind: Optional[str] = None,
                       equal_weights: Optional[bool] = None,
                       idchain: int = 0) -> List[np.ndarray]:
    """Load a MultiNest/PolyChord root (or explicit product path) as one
    chain ``[weight, -lnL, params...]``.

    ``equal_weights=None`` prefers the equal-weights product when present
    (see module docstring), falling back to the weighted ``<root>.txt``;
    True/False force one or the other.
    """
    from .reader import parse_chain_file
    if idchain > 0:
        raise ValueError(
            "nested-sampling products are one combined posterior set; "
            "-ic/idchain does not select anything for a nested-sampler "
            f"root (got idchain={idchain})")
    kind = kind or nested_kind(root)
    if kind is None:
        raise FileNotFoundError(f"{root!r} is not a MultiNest/PolyChord/"
                                "UltraNest root (no stats or equal-weights "
                                "product found)")
    if kind == "ultranest":
        return _load_ultranest(root, equal_weights)
    # the PolyChord equal-weights suffix itself ends in ".txt" — it is an
    # explicit EQUAL-weights request, not a weighted-file one
    explicit_weighted = (root.endswith(".txt")
                         and not root.endswith(_PC_EQUAL)
                         and os.path.isfile(root))
    if root.endswith((_MN_EQUAL, _PC_EQUAL)) and os.path.isfile(root):
        base, eq_path = _strip_product_suffix(root), root
    else:
        base = _strip_product_suffix(root)
        eq_path = base + (_MN_EQUAL if kind == "multinest" else _PC_EQUAL)
        if not os.path.isfile(eq_path):
            eq_path = None

    # an explicitly named weighted file is honored; bare roots prefer the
    # equal-weights product when one exists (see module docstring)
    use_equal = equal_weights if equal_weights is not None else (
        eq_path is not None and not explicit_weighted)
    if use_equal:
        if eq_path is None:
            raise FileNotFoundError(
                f"no equal-weights product for {kind} root {base!r}")
        logger.info("reading %s equal-weights file: %s", kind, eq_path)
        arr = parse_chain_file(eq_path)
        if kind == "multinest":
            return [_equal_weights_mn_to_chain(arr, eq_path)]
        return [_weighted_posterior_to_chain(arr, eq_path)]

    txt = base + ".txt"
    if not os.path.isfile(txt):
        raise FileNotFoundError(
            f"no weighted posterior file {txt!r} for {kind} root")
    logger.info("reading %s weighted posterior file: %s (rows are "
                "likelihood-ordered dead points, not an MCMC time series — "
                "burn-in/thinning fractions act on that ordering)",
                kind, txt)
    return [_weighted_posterior_to_chain(parse_chain_file(txt), txt)]


def _ultranest_lnz(root: str) -> Optional[Tuple[float, float]]:
    """UltraNest ``info/results.json`` (keys ``logz``/``logzerr``),
    resolved relative to the run dir that owns the posterior files (the
    parent of a ``chains/`` subdir, or the flat dir itself)."""
    import json
    loc = _ultranest_locate(root)
    if loc is None:
        return None
    dirpath = loc[0]
    rundir = (os.path.dirname(dirpath)
              if os.path.basename(dirpath) == "chains" else dirpath)
    for cand in (os.path.join(rundir, "info", "results.json"),
                 os.path.join(rundir, "results.json")):
        if os.path.isfile(cand):
            with open(cand, "r") as fp:
                res = json.load(fp)
            if isinstance(res, dict) and "logz" in res:
                return float(res["logz"]), float(res.get("logzerr", 0.0))
    return None


_MN_LNZ_RE = re.compile(
    r"Global Log-Evidence\s*:\s*(-?[\d.]+(?:[eEdD][+-]?\d+)?)"
    r"\s*\+/-\s*([\d.]+(?:[eEdD][+-]?\d+)?)")
_PC_LNZ_RE = re.compile(
    r"^log\(Z\)\s*=\s*(-?[\d.]+(?:[eEdD][+-]?\d+)?)"
    r"\s*\+/-\s*([\d.]+(?:[eEdD][+-]?\d+)?)")


def _fortran_float(tok: str) -> float:
    return float(tok.replace("D", "E").replace("d", "e"))


def sampler_lnz(root: str) -> Optional[Tuple[float, float]]:
    """The nested run's own (ln Z, err) from its stats file, or None.

    MultiNest ``<root>stats.dat``: the first ``... Global Log-Evidence :
    X +/- Y`` line (the plain nested-sampling estimate precedes the
    importance-sampling one).  PolyChord ``<root>.stats``: the global
    ``log(Z) = X +/- Y`` line (per-cluster ``log(Z_i)`` lines don't match).
    """
    try:
        kind = nested_kind(root)
        if kind is None:
            return None
        if kind == "ultranest":
            return _ultranest_lnz(root)
        base = _strip_product_suffix(root)
        path = base + (_MN_STATS if kind == "multinest" else _PC_STATS)
        if not os.path.isfile(path):
            return None
        pattern = _MN_LNZ_RE if kind == "multinest" else _PC_LNZ_RE
        with open(path, "r", errors="replace") as fp:
            for line in fp:
                m = pattern.search(line.strip())
                if m:
                    return (_fortran_float(m.group(1)),
                            _fortran_float(m.group(2)))
        logger.warning("no ln Z line found in %s", path)
    except (OSError, ValueError, TypeError, KeyError) as e:
        # this is an informational cross-check — a corrupt/unreadable stats
        # file (including {"logz": null} from an aborted UltraNest run)
        # must never fail (or discard) the evidence computation itself
        logger.warning("could not parse sampler lnZ near %s: %s", root, e)
    return None

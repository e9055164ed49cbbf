"""Compare two Planck-grid output trees cell by cell.

The executable golden-regression check: run the reference driver
(scripts/refbench_setup.sh) and this framework's driver on the same grid
(scripts/synth_grid.py, or the real COM_CosmoParams_fullGrid_R2.00), then

    python scripts/compare_grids.py <ref_outdir> <ours_outdir> [tol]

AllChains mode compares the AllChains column; SingleChains (-nc) outputs
compare every chain<i> column plus Mean_lnE_k1/Err_lnE_k1.  Exits nonzero
when any |d lnE| exceeds tol (default 1e-6, the north-star target —
measured agreement is ~1e-13).
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mcevidence_tpu.utils.table import read_csv  # noqa: E402


def compare(ref_dir: str, ours_dir: str, tol: float = 1e-6) -> int:
    pairs = []
    for mode in ("AllChains", "SingleChains"):
        for f in sorted(glob.glob(os.path.join(ref_dir, mode, "csv",
                                               "mce_*.csv"))):
            g = os.path.join(ours_dir, mode, "csv", os.path.basename(f))
            if os.path.exists(g):
                pairs.append((mode, f, g))
    if not pairs:
        print("no comparable per-dataset csvs found", file=sys.stderr)
        return 2
    maxd, ncells, worst = 0.0, 0, None
    for mode, f, g in pairs:
        ref = read_csv(f)
        ours = read_csv(g)
        cols = [c for c in ref.columns
                if c == "AllChains" or c.startswith("chain")
                or c in ("Mean_lnE_k1", "Err_lnE_k1") or c.startswith("lnE")]
        for model in ref.index:
            for c in cols:
                a = ref.at(model, c)
                b = (ours.at(model, c)
                     if model in ours.index and c in ours.columns else np.nan)
                if np.isnan(a) and np.isnan(b):
                    continue
                d = abs(float(a) - float(b))
                ncells += 1
                if d > maxd:
                    maxd, worst = d, (mode, os.path.basename(f), model, c)
    print(f"{ncells} cells compared over {len(pairs)} csv pairs; "
          f"max |d lnE| = {maxd:.3e} at {worst}")
    if maxd > tol:
        print(f"FAIL: exceeds tol {tol:g}", file=sys.stderr)
        return 1
    print(f"OK: within tol {tol:g}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print(__doc__)
        sys.exit(2)
    sys.exit(compare(sys.argv[1], sys.argv[2],
                     float(sys.argv[3]) if len(sys.argv) > 3 else 1e-6))

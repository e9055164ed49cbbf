"""Generate a synthetic Planck full grid at the PUBLISHED run's real sizes.

Reads the golden AllChains tables bundled with the reference
(planck_fullgrid_R2/AllChains/csv/mce_<dataset>.csv) to get every populated
(dataset, model) cell's chain length, cosmological dimensionality, and
base-normalized prior volume, then writes a CosmoMC-layout chain grid
(<out>/<model>/<dataset>/<model>_<dataset>_{1..4}.txt + .ranges +
.paramnames with a derived H0* column for the Riess-2016 importance hook)
with Gaussian chains of exactly those shapes.

This is the apples-to-apples wall-clock benchmark workload: the reference
driver (planck_mcevidence.py, which took ~30 min single-process on its
authors' CPU, :21-22) and this package's driver can both run it unmodified.

Usage: python scripts/synth_grid.py <outdir> [golden_csv_dir]
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mcevidence_tpu.utils.table import read_csv  # noqa: E402

GOLDEN = "/root/reference/planck_fullgrid_R2/AllChains/csv"
# names present in BOTH frameworks' cosmological-parameter registries
PARAM_NAMES = ["omegabh2", "omegach2", "theta", "tau", "omegak", "mnu",
               "w", "nnu", "yhe"]
NCHAINS = 4


def golden_cells(csv_dir: str):
    cells = []
    for f in sorted(glob.glob(os.path.join(csv_dir, "*.csv"))):
        df = read_csv(f)
        ds = os.path.basename(f).split("mce_", 1)[-1][:-4]
        for i, model in enumerate(df.index):
            nr = str(df["N_read"][i]).strip().strip(",")
            if not nr or nr == "nan":
                continue
            n = sum(int(x) for x in nr.split(",") if x)
            cells.append((ds, model, n, int(df["ndim"][i]),
                          float(df["PriorVol"][i])))
    return cells


def write_cell(outdir, ds, model, n, ndim, prior_vol, rng):
    d = os.path.join(outdir, model, ds)
    os.makedirs(d, exist_ok=True)
    root = os.path.join(d, f"{model}_{ds}")
    names = PARAM_NAMES[:ndim]
    mean = np.linspace(1.0, 2.0, ndim)
    sig = np.full(ndim, 0.05)
    widths = np.ones(ndim)
    widths[-1] = max(prior_vol, 1e-3)          # volume = prod(widths)
    per = [n // NCHAINS] * NCHAINS
    per[0] += n - sum(per)
    for c, nc in enumerate(per, start=1):
        theta = rng.normal(mean, sig, size=(nc, ndim))
        dm = (theta - mean) / sig
        neglnl = (0.5 * np.sum(dm * dm, axis=1)
                  + 0.5 * ndim * np.log(2 * np.pi) + np.sum(np.log(sig)))
        h0 = rng.normal(70.0, 3.0, size=nc)     # derived H0* column
        cols = np.column_stack([np.ones(nc), neglnl, theta, h0])
        np.savetxt(f"{root}_{c}.txt", cols, fmt="%.7e")
    with open(root + ".ranges", "w") as f:
        for nm, mu, wd in zip(names, mean, widths):
            f.write(f"{nm} {mu - wd / 2:.6g} {mu + wd / 2:.6g}\n")
        f.write("nuis1 0 0\n")                  # fixed param: must be skipped
    with open(root + ".paramnames", "w") as f:
        for nm in names:
            f.write(f"{nm}\t{nm}\n")
        f.write("H0*\tH_0\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else "/tmp/synthgrid"
    csv_dir = argv[1] if len(argv) > 1 else GOLDEN
    cells = golden_cells(csv_dir)
    rng = np.random.default_rng(20260816)
    total = 0
    for i, (ds, model, n, ndim, pv) in enumerate(cells):
        write_cell(outdir, ds, model, n, ndim, pv, rng)
        total += n
        if (i + 1) % 25 == 0:
            print(f"{i + 1}/{len(cells)} cells, {total} rows", flush=True)
    print(f"done: {len(cells)} cells, {total} rows -> {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

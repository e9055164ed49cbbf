"""End-to-end wall time of the two kNN engines on one GPU.

Runs the CLI (``cli.main``: 65,536 rows, d=8, kmax=5, 4 chain files) at each
precision and the grid driver (``planck.main`` over chip_smoke.py's
6-cell grid, AllChains and per-chain) with ``--engine xla`` and
``--engine triton``, in one process, each configuration warmed once and
then timed in the order xla, triton, triton, xla (repeated ``--pairs``
times).  Prints the card, every wall, and the medians.

Usage: python scripts/bench_engine_e2e.py [--pairs N]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        rc = fn(argv)
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{argv}: rc={rc}")
    return wall


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args(argv)
    import jax
    if jax.default_backend() != "gpu":
        print("bench_engine_e2e: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from mcevidence_tpu import cli, planck
    print(chip_smoke.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "cli", "chain")
        os.makedirs(os.path.dirname(root))
        chip_smoke.write_root(root, chip_smoke.CLI_ROWS, 8, seed=1)
        griddir = os.path.join(work, "grid")
        chip_smoke.write_grid(griddir)
        cases = [(f"cli --precision {prec}", cli.main,
                  [root, "-k", "5", "--precision", prec, "-vb", "0"])
                 for prec in ("refine", "device", "fast")]
        cases += [(f"grid {label}", planck.main,
                   ["--rootdir", griddir, "-o", os.path.join(work, label),
                    "-k", "3", "-nd", "2", "-v", "0", *extra])
                  for label, extra in (("AllChains", []),
                                       ("per-chain", ["-nc", "4"]))]
        for name, fn, base in cases:
            walls = {"xla": [], "triton": []}
            for engine in walls:                      # compile + warm
                _quiet(fn, [*base, "--engine", engine])
            for _ in range(args.pairs):
                for engine in ("xla", "triton", "triton", "xla"):
                    walls[engine].append(
                        _quiet(fn, [*base, "--engine", engine]))
            med = {e: float(np.median(w)) for e, w in walls.items()}
            print(f"{name}: xla median {med['xla']:.3f} s "
                  f"{[round(w, 3) for w in walls['xla']]}; triton median "
                  f"{med['triton']:.3f} s "
                  f"{[round(w, 3) for w in walls['triton']]}; "
                  f"xla/triton {med['xla'] / med['triton']:.2f}x",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

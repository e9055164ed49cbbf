"""Round-3 grid benchmark: bare-default driver runs, warm-process timing.

Runs the full synthetic Planck grid (scripts/synth_grid.py output) through
``planck.main`` with the NEW defaults (batched cells + device precision)
N_RUNS times in one process — run 1 pays compiles/program loads, later
runs are the steady-state number.  AllChains and
SingleChains (-nc 4) both measured; outputs compared cell-by-cell against
the reference outputs with scripts/compare_grids.py afterwards.

Usage: python scripts/bench_grid_r3.py <griddir> <outbase> [nchain] [runs]
"""

import sys
import time

sys.path.insert(0, ".")


def main():
    grid = sys.argv[1]
    outbase = sys.argv[2]
    nchain = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    runs = int(sys.argv[4]) if len(sys.argv) > 4 else 3
    from mcevidence_tpu.planck import main as planck_main

    base = ["--rootdir", grid, "-v", "0",
            "--parse-cache", "/tmp/mce_pcache"]
    if nchain:
        base += ["-nc", str(nchain)]
    for i in range(runs):
        out = f"{outbase}_run{i}"
        t0 = time.perf_counter()
        rc = planck_main([*base, "-o", out])
        dt = time.perf_counter() - t0
        print(f"RUN {i}: rc={rc} wall={dt:.1f}s "
              f"({'cold' if i == 0 else 'warm'} process-internal)",
              flush=True)


if __name__ == "__main__":
    main()

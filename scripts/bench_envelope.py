"""Single-device N-scaling envelope.

Measures the fast and device-refine paths end-to-end (fresh host prep +
host-to-device copy + device program + fetch) at growing N until the
requested ceiling, and prints the device-memory shape-math plan next to
each measured point so the guard's constants can be checked against
reality.

Usage: python scripts/bench_envelope.py [max_pow2 (default 20)] [d]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402

from mcevidence_tpu.ops.pipeline import (  # noqa: E402
    device_memory_budget_bytes, device_refine_auto_evidence,
    estimate_device_refine_hbm_bytes, fast_auto_evidence)
from mcevidence_tpu.utils.cache import enable_compilation_cache  # noqa: E402


def chain(n, d, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.normal(size=(n, d))
    lnl = -0.5 * np.sum(th * th, axis=1)
    return th, lnl


def timed(fn, *args, **kw):
    out = fn(*args, **kw)               # compile + warm
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return time.perf_counter() - t0, out


def main():
    enable_compilation_cache()
    max_pow = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    kmax = 5
    budget = device_memory_budget_bytes()
    print(f"backend={jax.default_backend()} d={d} kmax={kmax} "
          f"budget={'none' if budget is None else budget / 2**30} GiB")
    print(f"{'N':>9} {'plan GiB':>9} {'fast s':>8} {'fast pairs/s':>13} "
          f"{'device s':>9} {'dlnz fast-dev':>13}")
    for p in range(17, max_pow + 1):
        n = 2 ** p
        th, lnl = chain(n, d)
        plan = estimate_device_refine_hbm_bytes(n, n, d, kmax + 4)
        try:
            tf, fast = timed(fast_auto_evidence, th, lnl, kmax=kmax)
        except Exception as exc:
            print(f"{n:>9} {plan / 2**30:>9.2f} fast FAILED: "
                  f"{type(exc).__name__}: {exc}")
            break
        try:
            td, dev = timed(device_refine_auto_evidence, th, lnl, kmax=kmax)
            dd = float(np.max(np.abs(np.asarray(fast) - np.asarray(dev))))
            print(f"{n:>9} {plan / 2**30:>9.2f} {tf:>8.2f} "
                  f"{n * n / tf:>13.3g} {td:>9.2f} {dd:>13.2e}", flush=True)
        except Exception as exc:
            print(f"{n:>9} {plan / 2**30:>9.2f} {tf:>8.2f} "
                  f"{n * n / tf:>13.3g} device FAILED: "
                  f"{type(exc).__name__}: {exc}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark: GPU evidence wall-clock vs a float64 CPU reference.

Workload: auto evidence on a synthetic Planck-sized chain (N=65536, d=8,
kmax=5) — the shape class of the largest Planck full-grid chains (~6k-99k
rows x 6-8 params, BASELINE.md).  The jitted device step (whiten + kNN
selection + fused estimator) is timed warm, each repetition ending in
``block_until_ready``, and compared with the float64 reference of
``chip_smoke.py`` (scipy cKDTree + the reference estimator formula) on this
host's CPU.  Needs a GPU: on any other platform it prints a failure line.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}
value = NN pairs/sec on the device; vs_baseline = CPU reference wall /
device wall.
"""

import json
import os
import sys
import threading
import time

import numpy as np


def _failure_line(error: str, phase: str = "") -> str:
    """ONE schema-compatible JSON line marking a failed run (value 0);
    ``phase`` names the stage that blocked or failed."""
    rec = {"metric": "nn_pairs_per_sec_per_chip", "value": 0.0,
           "unit": "pairs/s", "vs_baseline": 0.0, "error": error}
    if phase:
        rec["phase"] = phase
    return json.dumps(rec)


class _Watchdog:
    """Phase-scoped deadline: pet() at each stage boundary re-arms the timer
    with that stage's own budget, so a slow-but-alive stage (a cold
    compile) is not killed by an unrelated stage's deadline, while a
    blocked stage still emits the failure line naming it."""

    current_phase = "start"            # class-level: read by __main__'s
                                       # except handler for the failure line

    def __init__(self):
        self._timer = None
        self.phase = "start"

    def pet(self, phase: str, seconds: float) -> None:
        self.cancel()
        self.phase = phase
        _Watchdog.current_phase = phase

        def fire():
            print(_failure_line(
                f"no progress within {seconds:.0f}s during '{phase}'",
                phase), flush=True)
            os._exit(2)
        self._timer = threading.Timer(seconds, fire)
        self._timer.daemon = True
        self._timer.start()

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


def synthetic_chain(n, ndim, seed=0):
    rng = np.random.default_rng(seed)
    mean = np.arange(1.0, ndim + 1.0)
    sigma = np.full(ndim, 0.05)
    theta = rng.normal(mean, sigma, size=(n, ndim))
    dm = (theta - mean) / sigma
    lnl = (-0.5 * np.sum(dm * dm, axis=1)
           - 0.5 * ndim * np.log(2 * np.pi) - np.sum(np.log(sigma)))
    return theta, lnl


def main():
    watchdog = _Watchdog()
    watchdog.pet("backend-init", 300.0)
    import jax
    import jax.numpy as jnp
    if jax.default_backend() != "gpu":
        raise RuntimeError(f"bench.py needs a GPU; JAX found "
                           f"{jax.default_backend()!r}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import card_line, reference_lnz
    from mcevidence_tpu.ops.estimator import log_evidence_from_knn
    from mcevidence_tpu.ops.knn import knn_select, select_engine
    from mcevidence_tpu.ops.pipeline import (device_refine_evidence,
                                             fast_auto_evidence)
    from mcevidence_tpu.ops.whiten import whiten_jnp
    from mcevidence_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    N, NDIM, KMAX = 65536, 8, 5
    REPS = 8
    theta, lnl = synthetic_chain(N, NDIM)
    engine = select_engine("auto")

    @jax.jit
    def evidence_step(samples, lnlike, weights):
        white, log_j, _ = whiten_jnp(samples)
        d2, _ = knn_select(white, white, KMAX, self_mode=True, engine=engine)
        return log_evidence_from_knn(
            jnp.sqrt(d2), lnlike, weights, jnp.sum(weights), NDIM,
            log_jacobian=log_j, log_prior_volume=0.0, k_start=1)

    # centre in f64 before the f32 cast (as the pipelines do)
    s32 = jnp.asarray(theta - theta.mean(axis=0), jnp.float32)
    l32 = jnp.asarray(lnl, jnp.float32)
    w32 = jnp.ones(N, jnp.float32)

    watchdog.pet("warmup-compile", 1200.0)
    mle = np.asarray(jax.block_until_ready(evidence_step(s32, l32, w32)))

    watchdog.pet("timed-run", 600.0)
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(evidence_step(s32, l32, w32))
        walls.append(time.perf_counter() - t0)
    dev_s = float(np.median(walls))

    watchdog.pet("cpu-reference", 900.0)
    t0 = time.perf_counter()
    oracle = reference_lnz(theta, lnl, np.ones(N), KMAX)
    cpu_s = time.perf_counter() - t0
    dlnz = float(np.max(np.abs(mle[1:] - oracle)))

    watchdog.pet("precision-modes", 900.0)
    device_refine_evidence(theta, lnl, kmax=KMAX)
    t0 = time.perf_counter()
    dev = device_refine_evidence(theta, lnl, kmax=KMAX)
    dev_wall = time.perf_counter() - t0
    fast = fast_auto_evidence(theta, lnl, kmax=KMAX)

    watchdog.cancel()
    d0 = jax.devices()[0]
    print(json.dumps({
        "metric": "nn_pairs_per_sec_per_chip",
        "value": N * N / dev_s,
        "unit": "pairs/s",
        "vs_baseline": cpu_s / dev_s,
        "rep_walls_s": walls,
        "device_wall_s": dev_s,
        "cpu_reference_wall_s": cpu_s,
        "device": {"platform": d0.platform, "kind": d0.device_kind,
                   "count": len(jax.devices())},
        "card": card_line(),
        "engine": engine,
        "workload": f"auto evidence N={N} d={NDIM} kmax={KMAX}",
        "max_abs_dlnz_vs_f64_reference_timed_step": dlnz,
        "max_abs_dlnz_vs_f64_reference_fast_mode": float(
            np.max(np.abs(np.asarray(fast) - oracle))),
        "max_abs_dlnz_vs_f64_reference_device_mode": float(
            np.max(np.abs(dev - oracle))),
        "device_mode_wall_s_incl_host_prep": dev_wall,
    }))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:
        print(_failure_line(f"{type(e).__name__}: {e}",
                            _Watchdog.current_phase), flush=True)
        raise

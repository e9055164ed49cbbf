"""Serving benchmark: steady-state latency + concurrency scaling of the
resident JSON-lines service (mcevidence_tpu.serve) on one warm process.

Generates CosmoMC-style toy roots at several chain sizes, starts ONE
service process, replays a shuffled request stream against it, and
reports per-size p50/p95 request wall (the service's own wall_s field,
host prep + device + fetch per request) plus the end-to-end stream
throughput.  First touch of each shape bucket pays the device program
load; the steady-state numbers are what a long-lived deployment sees.

Second leg (VERDICT r3 item 5): the same stream at the 2k-8k row sizes
through ``--workers K`` service processes with K outstanding client
requests, K = 1 vs 2 vs 4 — shows the dispatch/fetch overlap gain of the
pipelined serve loop with zero protocol change (responses stay in
request order).

Usage: python scripts/bench_serve.py [reps_per_size] [--clients 1,2,4]
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SIZES = (2000, 8000, 32768, 65536)
CONC_SIZES = (2000, 8000)
if os.environ.get("MCE_SERVE_BENCH_SIZES"):   # e.g. CPU smoke runs
    SIZES = tuple(int(x) for x in
                  os.environ["MCE_SERVE_BENCH_SIZES"].split(","))
    CONC_SIZES = SIZES[:2]
NDIM = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_root(dirpath: str, n: int, rng, tag: str = "") -> str:
    root = os.path.join(dirpath, f"toy{n}{tag}")
    names = ["omegabh2", "omegach2", "theta", "tau", "ns", "logA"][:NDIM]
    with open(root + ".ranges", "w") as fp:
        for name in names:
            fp.write(f"{name} -1 1\n")
    mean = np.zeros(NDIM)
    sig = np.full(NDIM, 0.05)
    for c in (1, 2):
        theta = rng.normal(mean, sig, size=(n // 2, NDIM))
        dm = (theta - mean) / sig
        lnl = (-0.5 * np.sum(dm * dm, axis=1)
               - 0.5 * NDIM * math.log(2 * math.pi) - np.sum(np.log(sig)))
        np.savetxt(f"{root}_{c}.txt",
                   np.column_stack([np.ones(n // 2), -lnl, theta]),
                   fmt="%.16e")
    return root


def _start_service(workers: int = 1) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "mcevidence_tpu.serve"]
    if workers > 1:
        cmd += ["--workers", str(workers)]
    return subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, cwd=REPO)


def _run_stream(proc: subprocess.Popen, reqs, window: int = 1):
    """Replay ``reqs`` keeping up to ``window`` outstanding; responses are
    read in request order (the service guarantees ordering).  Returns
    (total_wall_s, responses)."""
    responses = []
    t0 = time.perf_counter()
    sent = 0
    for i in range(len(reqs)):
        while sent < len(reqs) and sent - i < window:
            proc.stdin.write(json.dumps(reqs[sent]) + "\n")
            proc.stdin.flush()
            sent += 1
        resp = json.loads(proc.stdout.readline())
        assert resp["ok"], resp
        responses.append(resp)
    return time.perf_counter() - t0, responses


def main() -> int:
    args = [a for a in sys.argv[1:]]
    clients = (1, 2, 4)
    if "--clients" in args:
        i = args.index("--clients")
        clients = tuple(int(x) for x in args[i + 1].split(","))
        del args[i:i + 2]
    reps = int(args[0]) if args else 5
    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="mce_serve_bench_")
    try:
        return _run(tmp, rng, reps, clients)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(tmp: str, rng, reps: int, clients) -> int:
    # DISTINCT chain data per (size, rep), so that no cache along the way
    # (parse cache, staging buffers) can serve a repeat.  Same shapes =>
    # still one compile per bucket.
    nrep_roots = max(reps, 4)
    roots = {(n, r): make_root(tmp, n, rng, tag=f"_r{r}")
             for n in SIZES for r in range(nrep_roots)}

    reqs = []
    for r in range(reps):
        for n in SIZES:
            reqs.append({"id": f"{n}:{r}", "root": roots[(n, r)], "kmax": 2,
                         "precision": "device"})
    order = np.random.default_rng(1).permutation(len(reqs))
    reqs = [reqs[i] for i in order]

    proc = _start_service()
    total, responses = _run_stream(proc, reqs, window=1)
    proc.stdin.close()
    proc.wait(timeout=60)
    walls: dict = {n: [] for n in SIZES}
    for resp in responses:
        walls[int(resp["id"].split(":")[0])].append(resp["wall_s"])

    print(f"\n{len(reqs)} requests in {total:.1f}s "
          f"({len(reqs) / total:.2f} req/s end-to-end, one process)")
    print(f"{'rows':>7} {'first':>8} {'p50':>8} {'p95':>8}  (request wall_s)")
    for n in SIZES:
        w = walls[n]
        steady = sorted(w[1:]) or w
        p95_ix = min(len(steady) - 1, math.ceil(0.95 * len(steady)) - 1)
        print(f"{n:>7} {w[0]:>8.3f} {steady[len(steady) // 2]:>8.3f} "
              f"{steady[p95_ix]:>8.3f}")

    # concurrency leg: K outstanding requests vs --workers K, 2k-8k sizes;
    # per-request distinct roots here too (memoized repeats would report a
    # protocol-overlap number as a device-overlap one)
    conc_reqs = []
    for r in range(nrep_roots):
        for n in CONC_SIZES:
            conc_reqs.append({"id": f"{n}:{r}", "root": roots[(n, r)],
                              "kmax": 2, "precision": "device"})
    conc_reqs = [conc_reqs[i] for i in
                 np.random.default_rng(2).permutation(len(conc_reqs))]
    print(f"\nconcurrency scaling ({len(conc_reqs)} requests, "
          f"rows in {CONC_SIZES}):")
    print(f"{'clients':>8} {'wall_s':>8} {'req/s':>8} {'vs serial':>10}")
    base = None
    for k in clients:
        proc = _start_service(workers=k)
        # warm the shape buckets outside the timed stream
        _run_stream(proc, [{"id": f"w{n}", "root": roots[(n, 0)], "kmax": 2,
                            "precision": "device"} for n in CONC_SIZES],
                    window=1)
        wall, resp = _run_stream(proc, conc_reqs, window=k)
        proc.stdin.close()
        proc.wait(timeout=60)
        ids_ok = [r["id"] for r in resp] == [q["id"] for q in conc_reqs]
        assert ids_ok, "responses out of request order!"
        if base is None:
            base = wall
        print(f"{k:>8} {wall:>8.2f} {len(conc_reqs) / wall:>8.2f} "
              f"{base / wall:>9.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""GPU smoke test: the evidence pipeline's main paths on one card.

Runs, in this one process (a second JAX process could not reserve the
card's memory):

  (a) CLI      ``python -m mcevidence_tpu`` (``cli.main``) on a CosmoMC root of
               4 chain files, 65,536 rows, d=8, kmax=5, at --precision
               refine, device and fast;
  (b) grid     ``planck.main`` over a generated grid of 2 datasets x 3
               models (6k-99k rows, ndim 6-8, 4 chains per cell) at the
               defaults (device precision, batched cells), with
               ``--cross --seed 0`` and per chain (``-nc 4``, the dp x ring
               grid program); the csv/txt tables must exist;
  (c) serve    ``serve.serve`` answering 3 requests of different sizes;
  (d) kernel   the Triton-route kNN kernel against ``knn_select_xla`` and a
               float64 cKDTree at N=65536, d=8, k=9 and at the grid's
               batched shapes.

Every ln Z is compared with an independent float64 reference written here:
scipy cKDTree distances in a Cholesky-whitened space plus the reference
MCEvidence estimator formula.  Tolerances: refine 1e-10, device 1e-9,
fast 1e-3.  Any failed phase ends the run with a non-zero exit.

``--four-cards`` runs only the multi-device path: ``planck.main`` over the
same grid on every local card (the default dp x ring mesh), compared with
the same grid on one card and with the reference, plus
``sharded_auto_evidence`` at N=2^20, d=8 over the 4-card ring.

The last stdout line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Usage: python chip_smoke.py [--four-cards] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = {"refine": 1e-10, "device": 1e-9, "fast": 1e-3}
COSMO_NAMES = ["omegabh2", "omegach2", "theta", "tau", "logA", "ns", "w",
               "nnu"]
# (dataset, model, rows, ndim): the Planck R2 grid's shape ranges, in the
# grid driver's first two datasets
GRID_CELLS = [
    ("plikHM_TT_lowTEB", "base", 6000, 6),
    ("plikHM_TT_lowTEB", "base_omegak", 40000, 7),
    ("plikHM_TT_lowTEB", "base_nnu_r", 99000, 8),
    ("plikHM_TT_lowTEB_post_BAO", "base", 65536, 6),
    ("plikHM_TT_lowTEB_post_BAO", "base_omegak", 12000, 7),
    ("plikHM_TT_lowTEB_post_BAO", "base_nnu_r", 30000, 8),
]
H0, H0_ERR = 73.24, 1.74          # the grid driver's importance prior
CLI_ROWS = 65536
SERVE_ROWS = (8192, 24000)
RING_ROWS = 2 ** 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# independent float64 reference
# ---------------------------------------------------------------------------

def reference_lnz(s1, lnl, w, kmax, *, prior_volume=1.0, s2=None,
                  sumw=None) -> np.ndarray:
    """ln Z for k = 1..kmax-1 in float64: the reference MCEvidence estimator
    (volume_jk = pi^(d/2) D_jk^d / Gamma(1+d/2);
    dotp = sum_j volume_jk / w_j exp(lnL_j - lnL_max);
    ln Z = ln(SumW dotp / (S k_nn + 1) J) + lnL_max - ln V) with cKDTree
    distances.  Auto mode skips the self match (k_nn = k); cross mode
    (``s2``) searches s1's neighbours in s2 (k_nn = k + 1).  Whitening uses
    the covariance of all samples (J = sqrt(det C))."""
    from scipy.linalg import solve_triangular
    from scipy.spatial import cKDTree
    from scipy.special import gammaln, logsumexp
    s1 = np.asarray(s1, np.float64)
    lnl = np.asarray(lnl, np.float64)
    w = np.asarray(w, np.float64)
    n, d = s1.shape
    allx = s1 if s2 is None else np.concatenate([s1, s2])
    mu = allx.mean(axis=0)
    chol = np.linalg.cholesky(np.cov(allx.T))

    def white(x):
        return solve_triangular(chol, (x - mu).T, lower=True).T

    q = white(s1)
    tree = cKDTree(q if s2 is None else white(np.asarray(s2, np.float64)))
    dist, _ = tree.query(q, k=kmax, workers=-1)
    log_j = float(np.sum(np.log(np.diag(chol))))
    lmax = float(np.max(lnl))
    sumw = float(np.sum(w)) if sumw is None else float(sumw)
    out = []
    for k in range(1, kmax):
        with np.errstate(divide="ignore"):
            log_vol = (0.5 * d * math.log(math.pi) - gammaln(1 + 0.5 * d)
                       + d * np.log(dist[:, k]))
        log_dotp = logsumexp(log_vol + lnl - lmax - np.log(w))
        k_nn = k if s2 is None else k + 1
        out.append(math.log(sumw) + log_dotp - math.log(n * k_nn + 1.0)
                   + log_j + lmax - math.log(prior_volume))
    return np.array(out)


# ---------------------------------------------------------------------------
# synthetic CosmoMC chains
# ---------------------------------------------------------------------------

def make_chain(n, d, seed):
    """Correlated, offset Gaussian samples with their exact lnL, integer
    multiplicity weights and a derived H0 column."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d)) * 0.3 + np.eye(d)
    mean = np.linspace(0.5, 3.0, d) * 10.0
    z = rng.normal(size=(n, d))
    theta = mean + 0.05 * z @ a.T
    lnl = -0.5 * np.sum(z * z, axis=1)
    w = rng.integers(1, 4, size=n).astype(np.float64)
    h0 = rng.normal(70.0, 3.0, size=n)
    return theta, lnl, w, h0, mean


def write_root(root, n, d, seed, nfiles=4):
    """CosmoMC root: <root>_{1..nfiles}.txt, .ranges, .paramnames.  Returns
    (theta, lnl, w, h0, prior_volume) of the rows in file order."""
    theta, lnl, w, h0, mean = make_chain(n, d, seed)
    cols = np.column_stack([w, -lnl, theta, h0])
    for i, part in enumerate(np.array_split(cols, nfiles), start=1):
        np.savetxt(f"{root}_{i}.txt", part, fmt="%.17g")
    widths = np.linspace(1.0, 2.0, d)
    with open(root + ".ranges", "w") as fh:
        for nm, mu, wd in zip(COSMO_NAMES, mean, widths):
            fh.write(f"{nm} {float(mu - wd / 2)!r} {float(mu + wd / 2)!r}\n")
    with open(root + ".paramnames", "w") as fh:
        for nm in COSMO_NAMES[:d]:
            fh.write(f"{nm}\t{nm}\n")
        fh.write("H0*\tH_0\n")
    return theta, lnl, w, h0, float(np.prod(widths))


def check(label, got, want, tol, worst) -> None:
    got = np.asarray(got, np.float64)
    diff = float(np.max(np.abs(got - want)))
    print(f"  {label}: max|dlnZ| = {diff:.3e} (tol {tol:g})", flush=True)
    worst[label.split()[0]] = max(worst.get(label.split()[0], 0.0), diff)
    if not np.all(np.isfinite(got)) or diff > tol:
        raise AssertionError(f"{label}: |dlnZ| {diff:.3e} > {tol:g} "
                             f"(got {got}, want {want})")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_cli(work, worst):
    from mcevidence_tpu import cli
    root = os.path.join(work, "cli", "chain")
    os.makedirs(os.path.dirname(root))
    theta, lnl, w, _, pv = write_root(root, CLI_ROWS, 8, seed=1)
    want = reference_lnz(theta, lnl, w, 5, prior_volume=pv)
    for precision in ("refine", "device", "fast"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([root, "-k", "5", "--precision", precision,
                           "-vb", "0"])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli --precision {precision}: rc={rc}")
        got = [float(v) for v in
               re.findall(r"ln\(B\)\[k=\d+\] = (\S+)", buf.getvalue())]
        print(f"  cli --precision {precision}: {wall:.2f} s wall", flush=True)
        check(f"{precision} cli", got, want, TOL[precision], worst)
    return root, (theta, lnl, w, pv)


def write_grid(griddir):
    """The generated grid plus, per (dataset, model), what the reference
    needs: samples, lnL, weights, H0 column, prior volume."""
    cells = {}
    for i, (ds, model, n, d) in enumerate(GRID_CELLS):
        root = os.path.join(griddir, model, ds, f"{model}_{ds}")
        os.makedirs(os.path.dirname(root))
        cells[ds, model] = (root, *write_root(root, n, d, seed=100 + i))
    return cells


def grid_reference(cells, kmax, nchain=0, cross_seed=None):
    """{(dataset, model, chain): ln Z for k=1..kmax-1} with the grid
    driver's base-normalized prior volumes and its H0 importance prior;
    ``nchain=0`` is AllChains mode (chain 0 = all files)."""
    from mcevidence_tpu.chains.reader import ingest
    out = {}
    for (ds, model), (root, theta, lnl, w, h0, pv) in cells.items():
        pv_rel = pv / cells[ds, "base"][5]
        d = theta.shape[1]
        parts = ([(0, slice(None))] if nchain == 0 else list(enumerate(
            np.array_split(np.arange(len(theta)), nchain), start=1)))
        for ic, rows in parts:
            if cross_seed is None:
                imp = np.exp(-0.5 * ((h0[rows] - H0) / H0_ERR) ** 2)
                out[ds, model, ic] = reference_lnz(
                    theta[rows], lnl[rows], w[rows], kmax,
                    prior_volume=pv_rel, sumw=np.sum(w[rows] * imp))
                continue
            # the split is data preparation: take the driver's own, seeded
            source = root if ic == 0 else f"{root}_{ic}.txt"
            pair = ingest(source, split=True,
                          rng=np.random.default_rng(cross_seed))
            p1, p2 = pair.s1, pair.s2
            imp = np.exp(-0.5 * ((p1.samples[:, d] - H0) / H0_ERR) ** 2)
            out[ds, model, ic] = reference_lnz(
                p1.samples[:, :d], p1.lnp(), p1.weights, kmax,
                prior_volume=pv_rel, s2=p2.samples[:, :d],
                sumw=np.sum(p1.weights * imp))
    return out


# (label, extra planck flags, chains per cell (0 = AllChains), split seed):
# AllChains cells run one device program each; per-chain mode batches
# cells into the dp x ring grid program
GRID_RUNS = [("default", [], 0, None),
             ("cross", ["--cross", "--seed", "0"], 0, 0),
             ("per-chain", ["-nc", "4"], 4, None)]
FOUR_CARD_RUNS = [("per-chain", ["-nc", "4"], 4, None),
                  ("per-chain-cross", ["-nc", "4", "--cross", "--seed", "0"],
                   4, 0)]


def run_grid(griddir, outdir, extra, kmax, nchain):
    """planck.main over the grid; returns {(dataset, model, chain): ln Z}."""
    from mcevidence_tpu import planck
    from mcevidence_tpu.utils.table import read_csv
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = planck.main(["--rootdir", griddir, "-o", outdir, "-k", str(kmax),
                          "-nd", "2", "-v", "0", *extra])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"planck.main {extra}: rc={rc}")
    mode = os.path.join(outdir, "AllChains" if nchain == 0 else
                        "SingleChains")
    cols = (["AllChains"] if nchain == 0 else
            [f"chain{i}" for i in range(1, nchain + 1)])
    got = {}
    for ds in sorted({c[0] for c in GRID_CELLS}):
        for path in (os.path.join(mode, "csv", f"mce_{ds}.csv"),
                     os.path.join(mode, f"mce_{ds}.txt")):
            if not os.path.exists(path):
                raise AssertionError(f"missing table {path}")
        table = read_csv(os.path.join(mode, "csv", f"mce_{ds}.csv"))
        for model in table.index:
            for ic, col in enumerate(cols, start=0 if nchain == 0 else 1):
                got[ds, model, ic] = np.array(
                    [table.at(model, col)]
                    + [table.at(model, f"{col}_k{k}") for k in range(2, kmax)])
    for name in ("delta_lnE_all.txt", "mce_planck_fullgrid.txt"):
        if not os.path.exists(os.path.join(mode, name)):
            raise AssertionError(f"missing aggregate table {name}")
    return got, wall


def phase_grid(work, worst, kmax=3):
    griddir = os.path.join(work, "grid")
    cells = write_grid(griddir)
    for label, extra, nchain, seed in GRID_RUNS:
        got, wall = run_grid(griddir, os.path.join(work, f"out_{label}"),
                             extra, kmax, nchain)
        want = grid_reference(cells, kmax, nchain, seed)
        print(f"  grid {label}: {wall:.2f} s wall for {len(got)} cells",
              flush=True)
        for key in want:
            check(f"device grid {label} {'/'.join(map(str, key))}",
                  got[key], want[key], TOL["device"], worst)


def phase_serve(work, cli_root, cli_data, worst):
    from mcevidence_tpu import serve
    roots = []
    for n, d, seed in zip(SERVE_ROWS, (6, 7), (7, 8)):
        root = os.path.join(work, "serve", f"c{n}")
        os.makedirs(os.path.dirname(root), exist_ok=True)
        theta, lnl, w, _, pv = write_root(root, n, d, seed)
        roots.append((root, theta, lnl, w, pv))
    roots.append((cli_root, *cli_data))
    reqs = [{"id": i, "root": r[0], "kmax": 3, "precision": p}
            for i, (r, p) in enumerate(zip(roots,
                                           ("refine", "device", "fast")))]
    stream_in = io.StringIO("".join(json.dumps(r) + "\n" for r in reqs))
    stream_out = io.StringIO()
    t0 = time.perf_counter()
    rc = serve.serve(stream_in, stream_out)
    print(f"  serve: 3 requests in {time.perf_counter() - t0:.2f} s",
          flush=True)
    resps = [json.loads(line) for line in stream_out.getvalue().splitlines()]
    if rc != 0 or len(resps) != 3:
        raise AssertionError(f"serve rc={rc}, {len(resps)} responses")
    for req, resp, (root, theta, lnl, w, pv) in zip(reqs, resps, roots):
        if not resp.get("ok"):
            raise AssertionError(f"serve request {req['id']}: {resp}")
        want = reference_lnz(theta, lnl, w, 3, prior_volume=pv)
        check(f"{req['precision']} serve n={len(theta)}", resp["lnz"], want,
              TOL[req["precision"]], worst)


def _median_ms(fn, reps=5):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def _kth_f64(x, r, idx):
    d2 = np.sum((x[:, None, :] - r[np.maximum(idx, 0)]) ** 2, axis=-1)
    return np.sort(np.where(idx < 0, np.inf, d2), axis=-1)


def phase_kernel():
    import jax
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    from mcevidence_tpu.ops.knn import knn_select_xla
    from mcevidence_tpu.ops.knn_triton import (knn_select_triton,
                                               knn_select_triton_batched)
    rng = np.random.default_rng(3)
    n, d, k = 65536, 8, 9
    x = rng.normal(size=(n, d)).astype(np.float32)
    xj = jnp.asarray(x)
    _, ik = knn_select_triton(xj, xj, k, self_mode=True)
    _, ix = knn_select_xla(xj, xj, k, self_mode=True)
    ik, ix = np.asarray(ik), np.asarray(ix)
    x64 = x.astype(np.float64)
    d_ref, i_ref = cKDTree(x64).query(x64, k=k)
    agree_xla = np.mean(np.all(np.sort(ik, 1) == np.sort(ix, 1), axis=1))
    agree_f64 = np.mean(np.all(np.sort(ik, 1) == np.sort(i_ref, 1), axis=1))
    rel = np.max(np.abs(np.sqrt(_kth_f64(x64, x64, ik)) - d_ref)
                 / np.maximum(d_ref, 1e-30))
    t_k = _median_ms(lambda: knn_select_triton(xj, xj, k, self_mode=True))
    t_x = _median_ms(lambda: knn_select_xla(xj, xj, k, self_mode=True))
    print(f"  kernel N={n} d={d} k={k}: index sets agree with xla "
          f"{agree_xla:.6f}, with f64 {agree_f64:.6f}; max rel f64 distance "
          f"error at kernel indices {rel:.3e}; kernel {t_k:.3f} ms, "
          f"xla {t_x:.3f} ms", flush=True)
    if agree_xla < 0.999 or rel > 2.0 ** -10:
        raise AssertionError("kernel disagrees with the references")
    for b, rows, kb in ((4, 16384, 6), (4, 32768, 6), (1, 131072, 6)):
        q = jnp.asarray(rng.normal(size=(b, rows, d)).astype(np.float32))
        nr = jnp.asarray([rows - 7 * i for i in range(b)], jnp.int32)
        xla_b = jax.jit(lambda q, nr: jax.vmap(lambda a, m: knn_select_xla(
            a, a, kb, self_mode=True, nr=m))(q, nr))
        _, ibk = knn_select_triton_batched(q, q, kb, True, nr)
        _, ibx = xla_b(q, nr)
        ibk, ibx = np.asarray(ibk), np.asarray(ibx)
        agree = np.mean(np.all(np.sort(ibk, -1) == np.sort(ibx, -1), -1))
        qn = np.asarray(q, np.float64)
        rel = max(float(np.max(np.abs(
            _kth_f64(qn[i, :m], qn[i, :m], ibk[i, :m])
            - _kth_f64(qn[i, :m], qn[i, :m], ibx[i, :m]))
            / np.maximum(_kth_f64(qn[i, :m], qn[i, :m], ibx[i, :m]), 1e-30)))
            for i, m in enumerate(np.asarray(nr)))
        t_k = _median_ms(lambda: knn_select_triton_batched(q, q, kb, True,
                                                           nr), 3)
        t_x = _median_ms(lambda: xla_b(q, nr), 3)
        print(f"  kernel batched B={b} rows={rows} k={kb}: agree {agree:.6f}"
              f", max rel f64 d2 diff {rel:.3e}; kernel {t_k:.3f} ms, "
              f"xla {t_x:.3f} ms", flush=True)
        if agree < 0.999 or rel > 2.0 ** -9:
            raise AssertionError("batched kernel disagrees with xla")


def phase_four_cards(work, worst):
    """planck.main on every card (per-chain mode: the dp x ring grid
    program) vs one card and the reference, and the 4-card ring at
    N=2^20."""
    import jax
    from jax.sharding import Mesh

    from mcevidence_tpu.parallel import ring
    devs = jax.local_devices()
    print(f"  {len(devs)} local devices", flush=True)
    griddir = os.path.join(work, "grid")
    cells = write_grid(griddir)
    one_mesh = Mesh(np.array(devs[:1]).reshape(1, 1), ("dp", "ring"))
    for label, extra, nchain, seed in FOUR_CARD_RUNS:
        want = grid_reference(cells, 3, nchain, seed)
        many, wall_many = run_grid(griddir, os.path.join(
            work, f"out4_{label}"), extra, 3, nchain)
        default_mesh = ring._default_grid_mesh
        ring._default_grid_mesh = lambda mesh: one_mesh if mesh is None \
            else mesh
        try:
            one, wall_one = run_grid(griddir, os.path.join(
                work, f"out1_{label}"), extra, 3, nchain)
        finally:
            ring._default_grid_mesh = default_mesh
        print(f"  grid {label}: {len(devs)} cards {wall_many:.2f} s, "
              f"1 card {wall_one:.2f} s", flush=True)
        for key in want:
            name = "/".join(map(str, key))
            check(f"device grid-{len(devs)}cards {label} {name}",
                  many[key], want[key], TOL["device"], worst)
            check(f"device grid-{len(devs)}-vs-1card {label} {name}",
                  many[key], one[key], TOL["device"], worst)
    theta, lnl, w, _, _ = make_chain(RING_ROWS, 8, seed=9)
    want = reference_lnz(theta, lnl, w, 5)
    mesh = Mesh(np.array(devs), ("ring",))
    for precision in ("refine", "fast"):
        t0 = time.perf_counter()
        got = ring.sharded_auto_evidence(theta, lnl, w, kmax=5, mesh=mesh,
                                         precision=precision)
        print(f"  sharded_auto_evidence N={RING_ROWS} {precision}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        check(f"{precision} ring-{len(devs)}cards N={RING_ROWS}", got, want,
              TOL[precision], worst)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-device path (needs 4 cards)")
    p.add_argument("--workdir", default="",
                   help="where to write the generated chains and tables "
                        "(default: a temporary directory)")
    args = p.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    card = card_line()
    devs = jax.devices()
    print(card, flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)
    if args.four_cards and len(devs) < 4:
        print(f"chip_smoke --four-cards: found {len(devs)} device(s)",
              file=sys.stderr)
        return 2

    worst: dict = {}
    with tempfile.TemporaryDirectory(dir=args.workdir or None) as work:
        if args.four_cards:
            phases = [("four-cards", lambda: phase_four_cards(work, worst))]
        else:
            state = {}
            phases = [
                ("cli", lambda: state.update(cli=phase_cli(work, worst))),
                ("grid", lambda: phase_grid(work, worst)),
                ("serve", lambda: phase_serve(work, *state["cli"], worst)),
                ("kernel", phase_kernel),
            ]
        for name, run in phases:
            print(f"phase {name}", flush=True)
            t0 = time.perf_counter()
            run()
            print(f"phase {name}: ok in {time.perf_counter() - t0:.2f} s",
                  flush=True)
    print("max |dlnZ| vs the float64 reference: " + ", ".join(
        f"{k} {v:.3e}" for k, v in sorted(worst.items())), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

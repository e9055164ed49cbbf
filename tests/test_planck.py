"""End-to-end grid-driver test on a synthetic mini Planck grid
(reference planck_mcevidence.py semantics: discovery, base-normalized prior
volumes, per-dataset tables, aggregation artifacts)."""

import os
import pickle

import numpy as np
import pandas as pd
import pytest

from mcevidence_tpu import planck


def _write_chain(root, rng, ndim, n=600, nchains=2, h0=True):
    mean = np.linspace(1.0, 2.0, ndim)
    sig = np.full(ndim, 0.05)
    names = ["omegabh2", "omegach2", "theta", "tau", "w"][:ndim]
    for c in range(1, nchains + 1):
        theta = rng.normal(mean, sig, size=(n, ndim))
        dm = (theta - mean) / sig
        neglnl = 0.5 * np.sum(dm * dm, axis=1)
        w = np.ones(n)
        cols = [w, neglnl, theta]
        if h0:
            h0col = rng.normal(73.24, 1.74, size=n)   # H0 'derived' param
            cols = [w, neglnl, theta, h0col[:, None]]
        np.savetxt(f"{root}_{c}.txt", np.column_stack(cols), fmt="%.8e")
    with open(root + ".ranges", "w") as f:
        for nm, mu in zip(names, mean):
            f.write(f"{nm} {mu - 1} {mu + 1}\n")
    with open(root + ".paramnames", "w") as f:
        for nm in names:
            f.write(f"{nm}\tlatex\n")
        if h0:
            f.write("H0*\tH_0\n")


@pytest.fixture
def minigrid(tmp_path, rng):
    rootdir = tmp_path / "grid"
    ds = "plikHM_TT_lowTEB"
    for model, ndim in [("base", 4), ("base_w", 5)]:
        d = rootdir / model / ds
        d.mkdir(parents=True)
        _write_chain(str(d / f"{model}_{ds}"), rng, ndim)
    return str(rootdir), ds


def test_discovery(minigrid):
    rootdir, ds = minigrid
    roots, models = planck.avail_model_list(rootdir, ds)
    assert models == ["base", "base_w"]   # canonical order
    roots2, names2 = planck.avail_data_list(rootdir, "base")
    assert names2 == [ds]


def test_work_split_covers_everything():
    items = list(range(31))
    shards = planck.work_split(6, items)
    flat = sorted(x for s in shards for x in s)
    assert flat == items                      # no skip, no duplicate (Q10)
    assert max(len(s) for s in shards) - min(len(s) for s in shards) <= 1


def test_h0_reader(minigrid):
    rootdir, ds = minigrid
    root = os.path.join(rootdir, "base", ds, f"base_{ds}")
    names = planck.read_paramnames(root)
    assert names[-1] == "H0"
    assert planck.h0_index_for_chain(root) == 4
    fn = planck.make_h0_gauss_lnp(4)
    s = np.zeros((3, 5))
    s[:, 4] = [73.24, 73.24 + 1.74, 73.24 - 3.48]
    np.testing.assert_allclose(fn(s), [0.0, 0.5, 2.0])


def test_grid_run_and_aggregate(minigrid, tmp_path):
    rootdir, ds = minigrid
    outdir = str(tmp_path / "out")
    all_df = planck.run_grid(rootdir, outdir, kmax=2, verbose=0,
                             engine="xla", datasets=[ds])
    assert ds in all_df
    out = os.path.join(outdir, "AllChains")
    csv = os.path.join(out, "csv", f"mce_{ds}.csv")
    assert os.path.exists(csv)
    df = pd.read_csv(csv, index_col=0)
    assert list(df.index) == ["base", "base_w"]
    # base model's prior volume normalized to 1
    assert df.loc["base", "PriorVol"] == 1.0
    # delta column: max model has delta 0
    assert np.isclose(df["delta_lnE_k1"].max(), 0.0)
    # aggregation artifacts
    planck.aggregate(outdir, rootdir=rootdir, datasets=[ds], all_df=all_df)
    assert os.path.exists(os.path.join(out, "mce_planck_fullgrid.txt"))
    assert os.path.exists(os.path.join(out, "delta_lnE_all.txt"))
    big = pickle.load(open(os.path.join(out, "csv", "delta_lnE_all_df.pkl"),
                           "rb"))
    assert ds in big.columns


def test_grid_single_chain_mode(minigrid, tmp_path):
    rootdir, ds = minigrid
    outdir = str(tmp_path / "out2")
    planck.run_grid(rootdir, outdir, kmax=2, nchain=2, verbose=0,
                    engine="xla", datasets=[ds])
    csv = os.path.join(outdir, "SingleChains", "csv", f"mce_{ds}.csv")
    df = pd.read_csv(csv, index_col=0)
    for col in ("chain1", "chain2", "Mean_lnE_k1", "Err_lnE_k1"):
        assert col in df.columns
    assert (df["Err_lnE_k1"] >= 0).all()


def test_grid_sharded_run_and_merge(minigrid, tmp_path):
    # two shard "processes" then an aggregate-only merge (the MPI
    # replacement flow)
    rootdir, ds = minigrid
    outdir = str(tmp_path / "out3")
    for sid in range(2):
        planck.run_grid(rootdir, outdir, kmax=2, verbose=0, engine="xla",
                        datasets=[ds], num_shards=2, shard_id=sid)
    planck.aggregate(outdir, rootdir=rootdir, datasets=[ds])
    assert os.path.exists(os.path.join(outdir, "AllChains",
                                       "delta_lnE_all.txt"))


def test_grid_resume_skips(minigrid, tmp_path, caplog):
    rootdir, ds = minigrid
    outdir = str(tmp_path / "out4")
    planck.run_grid(rootdir, outdir, kmax=2, verbose=0, engine="xla",
                    datasets=[ds])
    import logging
    with caplog.at_level(logging.INFO, logger="mcevidence_tpu.planck"):
        out = planck.run_grid(rootdir, outdir, kmax=2, verbose=0,
                              engine="xla", datasets=[ds], resume=True)
    assert ds in out            # recovered from csv
    assert any("skipping" in r.message for r in caplog.records)


def test_grid_batched_cells_matches_per_cell(minigrid, tmp_path):
    # batched (refine, default) and per-cell modes must produce IDENTICAL
    # tables: same values to f64 noise, same info columns (VERDICT r1 #4).
    rootdir, ds = minigrid
    out_ref = planck.dataset_evidence(rootdir, ds, kmax=3, verbose=0,
                                      engine="xla")
    out_bat = planck.dataset_evidence(rootdir, ds, kmax=3, verbose=0,
                                      batch_cells=True)
    assert list(out_bat.index) == list(out_ref.index)
    assert list(out_bat.columns) == list(out_ref.columns)
    np.testing.assert_allclose(out_bat["AllChains"], out_ref["AllChains"],
                               atol=1e-9)
    # kmax=3 emits the k=2 column too (the reference dropped k>1 silently)
    assert "AllChains_k2" in out_bat.columns
    np.testing.assert_allclose(out_bat["AllChains_k2"],
                               out_ref["AllChains_k2"], atol=1e-9)
    np.testing.assert_allclose(out_bat["PriorVol"], out_ref["PriorVol"])
    for col in ("N_read", "N_used", "ndim"):
        assert list(out_bat[col]) == list(out_ref[col])


def test_grid_batched_cells_fast_mode(minigrid, tmp_path):
    rootdir, ds = minigrid
    out_ref = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                      engine="xla")
    out_bat = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                      batch_cells=True, precision="fast")
    # f32 batched vs f64 refine per-cell: ~1e-3 envelope
    np.testing.assert_allclose(out_bat["AllChains"], out_ref["AllChains"],
                               atol=5e-3)


def test_grid_batched_cross_matches_per_cell(minigrid, tmp_path):
    # cross-evidence in the grid program (VERDICT r1 #4): same split seed
    # => identical tables between batched and per-cell modes.
    rootdir, ds = minigrid
    out_ref = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                      engine="xla", cross=True, seed=11)
    out_bat = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                      batch_cells=True, cross=True, seed=11)
    np.testing.assert_allclose(out_bat["AllChains"], out_ref["AllChains"],
                               atol=1e-9)
    for col in ("N_read", "N_used"):
        assert list(out_bat[col]) == list(out_ref[col])
    # split mode: N_used lists both partitions
    assert "," in out_bat["N_used"][0].rstrip(",")


def test_procs_launcher(minigrid, tmp_path):
    # single-command multi-process fan-out + auto-aggregation (the
    # reference's mpirun -np N UX, planck_mcevidence.py:27-29)
    rootdir, ds = minigrid
    outdir = str(tmp_path / "outp")
    rc = planck.main(["--rootdir", rootdir, "-o", outdir, "-v", "0",
                      "--engine", "xla", "--procs", "2"])
    assert rc == 0
    assert os.path.exists(os.path.join(outdir, "AllChains",
                                       "delta_lnE_all.txt"))
    csv = os.path.join(outdir, "AllChains", "csv", f"mce_{ds}.csv")
    assert os.path.exists(csv)


def test_shard_aggregate_guard(minigrid, tmp_path):
    # a premature last-shard must NOT merge while other shards' csvs are
    # missing (ADVICE r1): it warns and exits 3 instead.
    rootdir, ds = minigrid
    outdir = str(tmp_path / "outg")
    rc = planck.main(["--rootdir", rootdir, "-o", outdir, "-v", "0",
                      "--engine", "xla", "--num-shards", "2",
                      "--shard-id", "1"])
    # shard 1 of 2 owns no dataset here (only 1 dataset exists) -> its csv
    # is missing -> guard refuses to aggregate
    assert rc == 3
    assert not os.path.exists(os.path.join(outdir, "AllChains",
                                           "delta_lnE_all.txt"))


def test_grid_batched_device_matches_per_cell(minigrid, tmp_path):
    # device-resident batched mode (scalars-only fetch): ~1e-7 of the
    # per-cell f64 refine tables
    rootdir, ds = minigrid
    out_ref = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                      engine="xla")
    out_dev = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                      batch_cells=True, precision="device")
    np.testing.assert_allclose(out_dev["AllChains"], out_ref["AllChains"],
                               atol=1e-6)
    for col in ("N_read", "N_used", "ndim"):
        assert list(out_dev[col]) == list(out_ref[col])


def test_distributed_two_process(minigrid, tmp_path):
    """Real 2-process ``jax.distributed`` run (CPU): coordinated processes
    each own a dataset shard; per-dataset csvs and the aggregate must be
    bit-identical to a single-process run (the honest stand-in for the
    reference's ``mpirun -np N`` multi-host path,
    planck_mcevidence.py:27-29,149-168)."""
    import socket
    import subprocess
    import sys

    rootdir, ds = minigrid
    # a second dataset so both processes own real work
    ds2 = "plikHM_TTTEEE_lowTEB"
    rng2 = np.random.default_rng(99)
    for model, ndim in [("base", 4), ("base_w", 5)]:
        d = os.path.join(rootdir, model, ds2)
        os.makedirs(d)
        _write_chain(os.path.join(d, f"{model}_{ds2}"), rng2, ndim)

    out1 = str(tmp_path / "single")
    rc = planck.main(["--rootdir", rootdir, "-o", out1, "-v", "0",
                      "--engine", "xla"])
    assert rc == 0

    with socket.socket() as s:          # free TCP port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out2 = str(tmp_path / "dist")
    workers = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(JAX_PLATFORMS="cpu",
                   JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
        workers.append(subprocess.Popen(
            [sys.executable, "-m", "mcevidence_tpu.planck",
             "--rootdir", rootdir, "-o", out2, "-v", "0", "--engine", "xla",
             "--distributed", "--no-aggregate"], env=env))
    for w in workers:
        assert w.wait(timeout=300) == 0
    rc = planck.main(["--rootdir", rootdir, "-o", out2, "-v", "0",
                      "--aggregate-only"])
    assert rc == 0

    for name in (f"csv/mce_{ds}.csv", f"csv/mce_{ds2}.csv",
                 "delta_lnE_all.txt", "mce_planck_fullgrid.txt"):
        a = open(os.path.join(out1, "AllChains", name), "rb").read()
        b = open(os.path.join(out2, "AllChains", name), "rb").read()
        assert a == b, f"{name} differs between 1-process and 2-process runs"


def test_grid_batched_device_per_chain_mode(minigrid, tmp_path):
    # SingleChains (per-chain) cells route through the batched dp x ring
    # device-refine program in fixed-quantum chunks (VERDICT r2 #1): the
    # tables must match the per-cell refine mode.  nchain=2 over 2 models
    # gives one full chunk of 4; nchain=1 gives a padded 2-cell chunk.
    rootdir, ds = minigrid
    for nchain in (2, 1):
        out_ref = planck.dataset_evidence(rootdir, ds, kmax=2, nchain=nchain,
                                          verbose=0, engine="xla")
        out_dev = planck.dataset_evidence(rootdir, ds, kmax=2, nchain=nchain,
                                          verbose=0, batch_cells=True,
                                          precision="device")
        for col in [f"chain{i}" for i in range(1, nchain + 1)]:
            np.testing.assert_allclose(out_dev[col], out_ref[col], atol=1e-6)
        for col in ("N_read", "N_used", "ndim", "PriorVol"):
            assert list(out_dev[col]) == list(out_ref[col])


def test_grid_batched_device_per_chain_cross(minigrid, tmp_path):
    rootdir, ds = minigrid
    out_ref = planck.dataset_evidence(rootdir, ds, kmax=2, nchain=2,
                                      verbose=0, engine="xla", cross=True,
                                      seed=7)
    out_dev = planck.dataset_evidence(rootdir, ds, kmax=2, nchain=2,
                                      verbose=0, batch_cells=True,
                                      precision="device", cross=True, seed=7)
    for col in ("chain1", "chain2"):
        np.testing.assert_allclose(out_dev[col], out_ref[col], atol=1e-8)
    for col in ("N_read", "N_used"):
        assert list(out_dev[col]) == list(out_ref[col])


def test_grid_quantum_env_allchains(minigrid, tmp_path, monkeypatch):
    # MCE_GRID_QUANTUM routes AllChains cells through the chunked batched
    # device path; tables must match the per-cell device mode
    rootdir, ds = minigrid
    out_ref = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                      batch_cells=True, precision="device")
    monkeypatch.setenv("MCE_GRID_QUANTUM", "2")
    out_q = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                    batch_cells=True, precision="device")
    np.testing.assert_allclose(out_q["AllChains"], out_ref["AllChains"],
                               atol=1e-8)
    for col in ("N_read", "N_used", "ndim"):
        assert list(out_q[col]) == list(out_ref[col])


@pytest.mark.parametrize("batch_cells", [False, True])
def test_corrupt_ranges_degrades_to_nan_row(minigrid, tmp_path, caplog,
                                            batch_cells):
    """A corrupt .ranges file must NaN only that model's row, like an
    unavailable chain (VERDICT r3 item 3) — the other models still complete
    and the aggregate artifacts are written."""
    import logging

    rootdir, ds = minigrid
    bad = os.path.join(rootdir, "base_w", ds, f"base_w_{ds}.ranges")
    with open(bad, "w") as f:
        f.write("omegabh2 not_a_number also_bad\n")
    with caplog.at_level(logging.WARNING, logger="mcevidence_tpu.planck"):
        df = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                     engine="xla", batch_cells=batch_cells)
    assert df is not None
    assert list(df.index) == ["base", "base_w"]
    assert np.isfinite(df.at("base", "AllChains"))
    assert np.isnan(df.at("base_w", "AllChains"))
    assert df.at("base_w", "PriorVol") == 0
    assert any("params_info failed" in r.message for r in caplog.records)
    # the full grid run + aggregation survives it too
    outdir = str(tmp_path / "out_corrupt")
    all_df = planck.run_grid(rootdir, outdir, kmax=2, verbose=0,
                             engine="xla", datasets=[ds],
                             batch_cells=batch_cells)
    assert ds in all_df
    planck.aggregate(outdir, rootdir=rootdir, datasets=[ds], all_df=all_df)
    assert os.path.exists(os.path.join(outdir, "AllChains",
                                       "delta_lnE_all.txt"))


def test_corrupt_base_ranges_keeps_other_models(minigrid, caplog):
    """Even the BASE model's metadata failing (the volume normalizer,
    reference planck_mcevidence.py:329-331) must not abort the dataset:
    the other models complete with unnormalized volumes."""
    import logging

    rootdir, ds = minigrid
    bad = os.path.join(rootdir, "base", ds, f"base_{ds}.ranges")
    os.remove(bad)
    # params_info falls back to log.param discovery and then fails; both
    # per-cell and batched paths must degrade, not raise
    with caplog.at_level(logging.WARNING, logger="mcevidence_tpu.planck"):
        df = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                     engine="xla")
    assert df is not None
    assert np.isnan(df.at("base", "AllChains"))
    assert np.isfinite(df.at("base_w", "AllChains"))
    # the lost base normalization is announced (round-4 review finding)
    assert any("NOT normalized" in r.message for r in caplog.records)


def test_grid_quantum_remainder_routes_per_cell(minigrid, monkeypatch):
    # 4 per-chain cells at quantum 3: one full chunk + a 1-cell remainder,
    # which must route through the per-cell path (no padded duplicate
    # dispatch, ADVICE r3) and still match the per-cell reference exactly
    rootdir, ds = minigrid
    out_ref = planck.dataset_evidence(rootdir, ds, kmax=2, nchain=2,
                                      verbose=0, engine="xla")
    monkeypatch.setenv("MCE_GRID_QUANTUM", "3")
    out_q = planck.dataset_evidence(rootdir, ds, kmax=2, nchain=2,
                                    verbose=0, batch_cells=True,
                                    precision="device")
    for col in ("chain1", "chain2"):
        np.testing.assert_allclose(out_q[col], out_ref[col], atol=1e-6)
    for col in ("N_read", "N_used", "ndim", "PriorVol"):
        assert list(out_q[col]) == list(out_ref[col])


def test_grid_batched_device_cross(minigrid, tmp_path):
    rootdir, ds = minigrid
    out_ref = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                      engine="xla", cross=True, seed=11)
    out_dev = planck.dataset_evidence(rootdir, ds, kmax=2, verbose=0,
                                      batch_cells=True, precision="device",
                                      cross=True, seed=11)
    np.testing.assert_allclose(out_dev["AllChains"], out_ref["AllChains"],
                               atol=1e-8)


def test_run_grid_rejects_bad_shard_config(minigrid, tmp_path):
    """REGRESSION (round-4 review): out-of-range --shard-id used to die
    with a bare IndexError; a negative one silently wrapped, duplicating
    one shard and leaving another uncomputed."""
    rootdir, _ = minigrid
    for num, sid in [(4, 4), (4, -1), (0, 0)]:
        with pytest.raises(ValueError, match="shard"):
            planck.run_grid(rootdir=rootdir, outdir=str(tmp_path),
                            num_shards=num, shard_id=sid)


def test_corrupt_paramnames_degrades(minigrid, tmp_path, caplog):
    """REGRESSION (round-4 review): a non-UTF-8 .paramnames used to raise
    UnicodeDecodeError through the model loop and kill the whole dataset;
    it must degrade to 'no H0 prior' with a warning."""
    import logging
    rootdir, ds = minigrid
    root = os.path.join(rootdir, "base", ds, f"base_{ds}")
    with open(root + ".paramnames", "wb") as fh:
        fh.write(b"\xff\xfe\x00junk\x80\x81")
    with caplog.at_level(logging.WARNING, logger="mcevidence_tpu.planck"):
        assert planck.h0_index_for_chain(root) is None
    assert any("unreadable .paramnames" in r.message for r in caplog.records)


def test_cli_kmax_validation(minigrid, tmp_path):
    rootdir, _ = minigrid
    with pytest.raises(SystemExit):
        planck.main(["-k", "1", "--rootdir", rootdir,
                     "-o", str(tmp_path)])


def test_procs_worker_envs_one_card_each():
    """--procs N on a GPU host: worker i sees only card i (of the cards
    the parent may see), so no two JAX processes share a card."""
    envs = planck._worker_envs(3, "", ["0", "2", "5"], {"A": "1"})
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "2", "5"]
    assert all(e["A"] == "1" for e in envs)
    # pinned to cpu (or no card in sight): every worker shares the parent's
    # environment, platform pin included
    for platforms, gpus in (("cpu", ["0", "1"]), ("", [])):
        envs = planck._worker_envs(4, platforms, gpus, {"A": "1"})
        assert len(envs) == 4
        assert all("CUDA_VISIBLE_DEVICES" not in e for e in envs)
    assert planck._worker_envs(2, "cpu", [], {})[0]["JAX_PLATFORMS"] == "cpu"


def test_procs_refuses_more_workers_than_cards():
    with pytest.raises(SystemExit, match="--procs 3 exceeds the 2 visible"):
        planck._worker_envs(3, "", ["0", "1"], {})
    with pytest.raises(SystemExit, match="exceeds the 1 visible"):
        planck._worker_envs(2, "cuda", ["7"], {})


def test_visible_gpus_follows_cuda_visible_devices(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3, 1")
    assert planck._visible_gpus() == ["3", "1"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert planck._visible_gpus() == []


def test_tables_match_the_pandas_layout(tmp_path):
    """The per-dataset csv is byte-identical to what pandas wrote for the
    same table (NaN cells empty, shortest round-trip floats, quoted
    strings), and reads back column for column."""
    from mcevidence_tpu.utils.table import Table, read_csv
    cols = {"AllChains": [-12.3456789012345, np.nan], "PriorVol": [1.0, 0.0],
            "ndim": [4, 0], "N_read": ["600,", ""]}
    t = Table(["base", "base_w"], cols)
    t.to_csv(str(tmp_path / "a.csv"))
    pd.DataFrame(cols, index=["base", "base_w"]).to_csv(
        str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_bytes() == \
        (tmp_path / "b.csv").read_bytes()
    back = read_csv(str(tmp_path / "a.csv"))
    assert back.index == ["base", "base_w"]
    assert back.columns == list(cols)
    np.testing.assert_array_equal(back["AllChains"], cols["AllChains"])
    assert list(back["N_read"]) == ["600,", ""]
    assert back.at("base", "PriorVol") == 1.0


def test_table_plain_text_layout():
    """Without the optional tabulate package the text table is aligned
    columns with two-decimal floats and NaN spelled out."""
    from mcevidence_tpu.utils.table import Table
    t = Table(["base", "base_omegak"], {"AllChains": [-1.5, np.nan],
                                       "ndim": [6, 7]})
    assert t._plain_text().splitlines() == [
        "             AllChains  ndim",
        "base             -1.50     6",
        "base_omegak        NaN     7",
    ]


def test_grid_device_deferred_cells_keep_their_inputs(tmp_path, monkeypatch):
    """REGRESSION: per-cell device dispatches are all issued before any
    fetch, and cells of one row bucket share pooled staging buffers; a
    cell's host-to-device copy must finish before the next cell's prep
    refills them.  Before the fix, later cells of a dataset ran on another
    cell's coordinates (|dlnZ| up to ~2)."""
    rng = np.random.default_rng(5)
    rootdir = tmp_path / "grid"
    ds = "plikHM_TT_lowTEB"
    for model, ndim, n in [("base", 4, 1600), ("base_w", 5, 600)]:
        d = rootdir / model / ds
        d.mkdir(parents=True)
        _write_chain(str(d / f"{model}_{ds}"), rng, ndim, n=n, nchains=4)
    monkeypatch.setenv("MCE_GRID_QUANTUM", "1")
    out_ref = planck.dataset_evidence(str(rootdir), ds, kmax=3, nchain=4,
                                      verbose=0, engine="xla", cross=True,
                                      seed=0)
    out_dev = planck.dataset_evidence(str(rootdir), ds, kmax=3, nchain=4,
                                      verbose=0, batch_cells=True,
                                      precision="device", cross=True, seed=0)
    for col in [f"chain{i}" for i in range(1, 5)]:
        np.testing.assert_allclose(out_dev[col], out_ref[col], atol=1e-8)

"""bench.py failure protection: the caller must always get ONE
machine-readable JSON line, never an indefinite hang.  The watchdog is
phase-scoped (pet() re-arms per stage).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=60)


def test_watchdog_fires_with_schema_line_naming_the_phase():
    p = _run("import bench, time; w = bench._Watchdog(); "
             "w.pet('warmup-compile', 0.3); time.sleep(30)")
    assert p.returncode == 2
    d = json.loads(p.stdout.strip().splitlines()[-1])
    assert d["metric"] == "nn_pairs_per_sec_per_chip"
    assert d["value"] == 0.0 and d["vs_baseline"] == 0.0
    assert "error" in d
    assert d["phase"] == "warmup-compile"
    assert "warmup-compile" in d["error"]


def test_watchdog_pet_rearms_instead_of_stacking():
    # the first (short) deadline must be cancelled by the second pet: only
    # a live stage's own budget applies
    p = _run("import bench, time; w = bench._Watchdog(); "
             "w.pet('a', 0.2); w.pet('b', 5.0); time.sleep(0.5); "
             "w.cancel(); print('clean')")
    assert p.returncode == 0
    assert p.stdout.strip() == "clean"


def test_watchdog_cancel_is_clean():
    p = _run("import bench, time; w = bench._Watchdog(); w.pet('x', 0.3); "
             "w.cancel(); time.sleep(0.6); print('clean')")
    assert p.returncode == 0
    assert p.stdout.strip() == "clean"


def test_failure_line_schema_with_phase():
    import bench
    d = json.loads(bench._failure_line("boom", "backend-init"))
    assert d["value"] == 0.0 and d["phase"] == "backend-init"
    d2 = json.loads(bench._failure_line("boom"))
    assert "phase" not in d2


def test_bench_refuses_a_cpu_backend():
    """bench.py measures a GPU: on the CPU it must print the failure line
    and exit non-zero, never a CPU number under the device metric."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "bench.py"], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert p.returncode != 0
    d = json.loads(p.stdout.strip().splitlines()[-1])
    assert d["value"] == 0.0 and "needs a GPU" in d["error"]

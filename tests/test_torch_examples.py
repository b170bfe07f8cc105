"""Smoke-test the port's example scripts end to end on the CPU, with the
spot checks of tests/test_examples.py.  Each runs in a subprocess (same
interpreter) at tiny sizes."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.slow  # subprocess smokes, as tests/test_examples.py


def _run(script: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    return subprocess.run([sys.executable, str(REPO / script), *args],
                          capture_output=True, text=True, timeout=600, env=env, cwd=REPO)


def test_quickstart_runs_on_the_cpu():
    proc = _run("examples/torch_quickstart.py", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "collatz = [  0   8  16 111 118 178] (expect 0 8 16 111 118 178)" in proc.stdout
    for backend in ("pc", "local", "local_eager", "reference"):
        assert f"{backend:12s} fib(10) -> 55" in proc.stdout
    assert "CacheInfo(hits=1, misses=2, entries=2, lowerings=1, traces=1)" in proc.stdout
    assert "verifier:      ok" in proc.stdout


def test_quickstart_without_a_device_refuses_the_cpu():
    """Imported with no card, the module loads; run with no --device, the
    first call raises the port's no-CUDA error instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would use it")
    proc = _run("examples/torch_quickstart.py")
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "fib(n)" not in proc.stdout


def test_nuts_logreg_runs_tiny():
    proc = _run("examples/torch_nuts_logreg.py", "--device", "cpu", "--chains", "3",
                "--steps", "2")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "converged: True" in proc.stdout
    assert "finite: True" in proc.stdout


def test_irlint_lints_the_quickstart_handle():
    proc = _run("tools/torch_irlint.py", "examples/torch_quickstart.py:fib", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "torch_irlint: 1 program(s) verified clean" in proc.stdout


def test_train_lm_quick_runs_on_the_cpu():
    """The reduced config trains, recovers from the injected failure and
    its loss falls."""
    proc = _run("examples/torch_train_lm.py", "--quick", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "on cpu" in proc.stdout
    assert "injecting simulated node failure at step 30" in proc.stdout
    assert "final step 60, restarts 1" in proc.stdout
    assert "(improved)" in proc.stdout


def test_serve_lm_closed_loop_matches_the_oracle_on_the_cpu():
    proc = _run("examples/torch_serve_lm.py", "--device", "cpu", "--lanes", "3",
                "--requests-per-lane", "2", "--max-new", "6", "--check")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "engine on cpu: 3 lanes x 2 requests, program blocks:" in proc.stdout
    assert "tok/s), decode-batch utilization" in proc.stdout
    assert "matches sequential oracle: True" in proc.stdout


def test_serve_lm_open_loop_on_the_cpu():
    proc = _run("examples/torch_serve_lm.py", "--device", "cpu", "--lanes", "2",
                "--open-loop", "--num-requests", "5", "--max-new", "6")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count(" done on lane ") == 5
    assert "served 5 requests / " in proc.stdout and "p99 " in proc.stdout


def test_serve_lm_without_a_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would use it")
    proc = _run("examples/torch_serve_lm.py", "--lanes", "2")
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "generated" not in proc.stdout

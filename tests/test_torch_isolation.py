"""The PyTorch port stands alone: importing every module of ``repro_torch``
loads neither JAX nor the JAX package, and no source of the port (nor
``chip_smoke.py``, the card's tests, what the lane-sharding tests' ranks
run, the port's Fig. 5 / Fig. 6 and serving benchmarks, their driver, its
chaos harness and its examples) imports either."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps({"count": len(names), "bad": bad}))
"""


def test_importing_the_port_loads_no_jax_and_no_reference_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["count"] >= 15, f"walked only {report['count']} modules"
    assert report["bad"] == [], f"the port imported {report['bad']}"


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append(node.module)
    return found


# chip_smoke.py, the card's tests and the port's benchmarks (with the shared
# benchmark helpers they import) run where there is no JAX.
SOURCES = sorted(PORT.rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py",
    REPO / "tests" / "torch_mesh_workers.py",
    REPO / "tools" / "torch_nuts_ab.py", REPO / "tools" / "torch_chaos.py",
    REPO / "tools" / "torch_vmtrace.py", REPO / "tools" / "torch_pgo.py",
    REPO / "tools" / "torch_irlint.py", REPO / "tools" / "torch_verify_cost.py",
    REPO / "tools" / "torch_serve_ab.py",
    REPO / "benchmarks" / "torch_fig5.py", REPO / "benchmarks" / "torch_fig6.py",
    REPO / "benchmarks" / "torch_serve_bench.py", REPO / "benchmarks" / "torch_run.py",
    REPO / "benchmarks" / "common.py",
] + sorted((REPO / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_or_reference_import_in_source(path):
    for mod in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


_BENCH_PROBE = """
import json, pathlib, runpy, sys
import benchmarks.torch_fig5, benchmarks.torch_fig6, benchmarks.torch_serve_bench
import benchmarks.torch_run
import tools.torch_chaos
for path in sorted(pathlib.Path("examples").glob("torch_*.py")):
    runpy.run_path(str(path), run_name="probe")  # the module body, not its main
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps(bad))
"""


def test_importing_the_fig_benchmarks_loads_no_jax():
    """The Fig. 5 / Fig. 6 and serving benchmarks, their driver, the chaos
    harness and the examples."""
    proc = subprocess.run(
        [sys.executable, "-c", _BENCH_PROBE], capture_output=True, text=True,
        timeout=300, cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src")},
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []

"""The port's benchmark driver (``benchmarks/torch_run.py``, the
counterpart of ``benchmarks/run.py``) on the CPU: its arguments reach each
sub-benchmark (their mains replaced by recorders), one real tiny run
writes records that parse as strict JSON, ``--mesh`` reaches fig5 and
serve as in the JAX driver, ``--only roofline`` renders the dry-run's
records of both production meshes, and what the port must never do is
refused — ``--use-kernel off`` (a fallback on the card) and the JAX
package's record paths."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from benchmarks import torch_run  # noqa: E402
from benchmarks.common import validate_bench_json  # noqa: E402


@pytest.fixture
def recorded(monkeypatch):
    """Each sub-benchmark's argv; each writes a stand-in record at its
    ``--json`` path."""
    calls = {}

    def recorder(name):
        def main(argv):
            calls[name] = list(argv)
            path = argv[argv.index("--json") + 1]
            with open(path, "w") as f:
                json.dump({"benchmark": name}, f)
            return 0
        return main

    for name in ("torch_fig5", "torch_fig6", "torch_serve_bench"):
        monkeypatch.setattr(getattr(torch_run, name), "main", recorder(name))
    return calls


def test_arguments_reach_each_sub_benchmark(recorded, tmp_path):
    paths = {k: str(tmp_path / f"{k}.json") for k in ("fig5", "fig6", "serve")}
    rc = torch_run.main([
        "--full", "--batches", "4,8", "--schedule", "earliest,sweep",
        "--compact-every", "none,1", "--pgo", "on,off", "--use-kernel", "on",
        "--serve-arrivals", "poisson", "--serve-requests", "5", "--device", "cpu",
        "--json-out", paths["fig5"], "--fig6-json-out", paths["fig6"],
        "--serve-json-out", paths["serve"]])
    assert rc == 0
    assert recorded["torch_fig5"] == [
        "--full", "--batches", "4,8", "--device", "cpu", "--fuse", "on,off",
        "--schedule", "earliest,sweep", "--compact-every", "none,1", "--pgo", "on,off",
        "--json", paths["fig5"]]
    assert recorded["torch_fig6"] == ["--full", "--batches", "4,8", "--device", "cpu",
                                      "--json", paths["fig6"]]
    assert recorded["torch_serve_bench"] == [
        "--device", "cpu", "--arrivals", "poisson", "--num-requests", "5",
        "--json", paths["serve"]]


def test_only_selects_and_defaults_land_at_the_repo_root(recorded, monkeypatch, tmp_path):
    assert torch_run.REPO_ROOT == Path(torch_run.__file__).resolve().parent.parent
    monkeypatch.setattr(torch_run, "REPO_ROOT", tmp_path)  # the records' default directory
    torch_run.main(["--only", "serve,fig6"])
    assert sorted(recorded) == ["torch_fig6", "torch_serve_bench"]
    assert recorded["torch_serve_bench"] == [
        "--arrivals", "closed", "--json", str(tmp_path / "BENCH_serve_torch.json")]
    assert recorded["torch_fig6"] == ["--json", str(tmp_path / "BENCH_fig6_torch.json")]


def test_a_tiny_cpu_run_writes_strict_records(tmp_path):
    fig6, serve = tmp_path / "fig6.json", tmp_path / "serve.json"
    rc = torch_run.main(["--device", "cpu", "--only", "fig6,serve", "--batches", "2",
                         "--serve-arrivals", "poisson", "--serve-requests", "4",
                         "--fig6-json-out", str(fig6), "--serve-json-out", str(serve)])
    assert rc == 0
    validate_bench_json([str(fig6), str(serve)])
    f6, sv = json.loads(fig6.read_text()), json.loads(serve.read_text())
    assert f6["benchmark"] == "fig6_utilization_torch" and f6["config"]["batches"] == [2]
    assert sv["benchmark"] == "serve_bench_torch" and sv["device"]["type"] == "cpu"
    assert {r["mode"] for r in sv["records"]} == {"poisson", "batch"}
    assert all(r["num_requests"] == 4 for r in sv["records"])


@pytest.mark.parametrize("mesh, serve_mesh", [("8", "8"), ("none,8", "8")])
def test_mesh_reaches_fig5_and_serve(recorded, tmp_path, mesh, serve_mesh):
    """As the JAX driver: fig5's pc arms take the rank counts, serve the
    largest, fig6 none (each benchmark starts its own ranks)."""
    paths = {k: str(tmp_path / f"{k}.json") for k in ("fig5", "fig6", "serve")}
    assert torch_run.main(["--mesh", mesh, "--device", "cpu", "--json-out", paths["fig5"],
                           "--fig6-json-out", paths["fig6"],
                           "--serve-json-out", paths["serve"]]) == 0
    fig5, serve = recorded["torch_fig5"], recorded["torch_serve_bench"]
    assert fig5[fig5.index("--mesh") + 1] == mesh
    assert serve[serve.index("--mesh") + 1] == serve_mesh
    assert "--mesh" not in recorded["torch_fig6"]


@pytest.mark.parametrize("argv, says", [
    (["--only", "roofline,fig7"], "unknown benchmarks"),
    (["--only", "fig5,roofline", "--use-kernel", "off"], "fallback"),
    (["--use-kernel", "off"], "fallback"),
    (["--use-kernel", "on,off"], "fallback"),
    (["--json-out", "BENCH_fig5.json"], "JAX package's record"),
    (["--serve-json-out", "out/BENCH_serve.json"], "JAX package's record"),
    (["--only", "fig7"], "unknown benchmarks"),
])
def test_refusals(argv, says, recorded):
    with pytest.raises(SystemExit, match=says):
        torch_run.main(argv)
    assert recorded == {}


def test_roofline_renders_the_dryrun_records(tmp_path, capsys):
    """A reduced-config cell's record (SmolLM-135M, 2 layers, decode_32k on
    32 x 8; the dry-run runs in its own process, whose fake process group
    it opens) rendered by ``--only roofline`` for both production meshes."""
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "tests.torch_dryrun_workers", "--record",
         str(tmp_path / "smollm-135m__decode_32k__32x8.json")], cwd=root,
        env={**os.environ, "PYTHONPATH": os.pathsep.join([str(root / "src"), str(root)])},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert torch_run.main(["--only", "roofline", "--dryrun-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "mesh 32x8" in out and "mesh 2x32x8" in out
    row = next(line for line in out.splitlines() if line.startswith("smollm-135m"))
    assert "decode_32k" in row and row.split()[5] in ("compute", "memory", "collective")

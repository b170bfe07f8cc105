"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files."""
from __future__ import annotations

import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
E2E = {m["name"] for m in MANIFEST["end_to_end"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json_bytes()) <= 64 * 1024


def json_bytes() -> bytes:
    return (harness.ROOT / "BENCHMARK.json").read_bytes()


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(names) == len(set(names))
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in E2E
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E and _line(m["layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.resolve(MANIFEST, cell)
    assert c.config["name"] == c.workload["config"]
    assert hasattr(harness.driver(c.config["kind"]), "run")
    counts = harness.counts(c.config["target"])
    assert counts.grad_flops(c.config) > 0
    assert {"backend", "chains", "check_chains"} <= set(c.traffic)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "grads_per_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]).read)


def test_every_file_is_used():
    used = {harness.ROOT / c["file"] for c in MANIFEST["configs"]}
    assert used == set((harness.HERE / "configs").glob("*.json"))
    traffic = {w["traffic"] for w in MANIFEST["workloads"]}
    assert traffic == {p.stem for p in (harness.HERE / "traffic").glob("*.json")}
    metrics = {m["name"] for m in MANIFEST["per_layer"]}
    assert metrics == {p.stem for p in (harness.HERE / "metrics").glob("*.py")} - {"__init__"}


def test_logistic_regression_counts_by_hand():
    counts = harness.counts("logistic_regression")
    cfg = {"num_data": 3, "dim": 2}
    # X w: 3 rows x 2 multiply-adds; X^T g: 2 rows x 3 multiply-adds -> 24.
    assert counts.grad_matmul_flops(cfg) == 12 + 12
    # plus 5 a point (15) and 1 a regressor (2).
    assert counts.grad_flops(cfg) == 24 + 15 + 2
    # X twice (2 x 6 x 4 bytes) an execution; per lane w, Xw, g, X^T g rows.
    assert counts.matmul_bytes(cfg, execs=1, lanes=2) == 48 + 2 * (8 * 3 + 8 * 2)


def test_correlated_gaussian_counts_by_hand():
    counts = harness.counts("correlated_gaussian")
    # d=3: 3 products on the diagonal, 2 x 2 multiply-adds off it, 3 signs.
    assert counts.grad_flops({"dim": 3}) == 3 + 8 + 3
    assert counts.grad_matmul_flops({"dim": 3}) == 0

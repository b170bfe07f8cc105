"""The port's Fig. 5 and Fig. 6 benchmarks (``benchmarks/torch_fig5.py``,
``benchmarks/torch_fig6.py``) at tiny sizes on the CPU: every arm and
every pc variant gives a complete record, the JSON files are strict, and
Fig. 6's pc and local utilizations equal the JAX benchmark's on the same
inputs.  ``torch_fig5 --pgo on,off`` runs, and its pgo arms strictly cut
dispatches and masked updates; Fig. 6 has no ``--pgo``, as the JAX
benchmark has none.  ``--mesh 2`` starts two gloo ranks and records
``mesh2`` pc arms (Fig. 5: a batch a rank; Fig. 6: the whole batch).
"""
import json

import pytest

pytest.importorskip("torch")

from benchmarks import fig6_utilization as j_fig6  # noqa: E402
from benchmarks import torch_fig5, torch_fig6  # noqa: E402
from benchmarks.common import validate_bench_json  # noqa: E402

TINY5 = dict(num_data=40, dim=3, num_steps=2, max_tree_depth=4, eps=0.1, repeats=1)


def test_fig5_records_every_arm():
    variants = (("earliest", True, None), ("popular", True, None), ("lookahead", True, 1),
                ("sweep", True, None), ("earliest", False, 1))
    tab, recs = torch_fig5.throughput_sweep([1, 3], pc_variants=variants, device="cpu",
                                            **TINY5)
    assert len(tab.rows) == 2 and len(tab.columns) == 1 + len(variants) + 4
    pc = [r for r in recs if r["arm"].startswith("pc[")]
    assert len(pc) == 2 * len(variants)
    for r in pc:
        assert r["grads_per_sec"] > 0 and r["vm_steps"] > 0
        assert 0 < r["mean_occupancy"] <= 1 and 0 < r["mean_lane_occupancy"] <= 1
    for arm in ("local", "local_eager", "unbatched", "iterative"):
        got = [r for r in recs if r["arm"] == arm]
        assert [r["batch"] for r in got] == [1, 3], arm
        assert all(r["grads_per_sec"] > 0 and r["grads"] > 0 for r in got), arm
    # Every pc variant and the other batched arms do the same gradient work.
    for z in (1, 3):
        grads = {r["grads"] for r in recs if r["batch"] == z and r["arm"] != "iterative"}
        assert len(grads) == 1, grads


def test_fig5_cli_writes_strict_json(tmp_path):
    path = tmp_path / "fig5.json"
    torch_fig5.main(["--device", "cpu", "--batches", "1", "--repeats", "1",
                     "--arms", "pc,iterative", "--json", str(path)])
    validate_bench_json([str(path)])
    payload = json.loads(path.read_text())
    assert payload["device"]["type"] == "cpu"
    assert [r["arm"] for r in payload["records"]] == ["pc", "iterative"]


def test_fig6_equals_the_jax_benchmark():
    kw = dict(dim=4, num_steps=2, max_tree_depth=4)
    variants = (("earliest", True, None), ("popular", False, 1))
    tab, records = torch_fig6.utilization_sweep([3], pc_variants=variants,
                                                device="cpu", **kw)
    j_tab = j_fig6.utilization_sweep([3], pc_variants=tuple(
        (s, f, None, c, False) for s, f, c in variants), **kw)
    assert tab.columns == j_tab.columns
    assert [list(r) for r in tab.rows] == [list(r) for r in j_tab.rows]
    assert records[0]["local"] == j_tab.rows[0][3]


def test_fig6_cli_writes_strict_json(tmp_path):
    path = tmp_path / "fig6.json"
    torch_fig6.main(["--device", "cpu", "--batches", "1", "--json", str(path)])
    validate_bench_json([str(path)])
    (rec,) = json.loads(path.read_text())["records"]
    assert 0 < rec["local"] <= 1 and 0 < rec["pc"]["pc"] <= 1


def test_fig5_mesh_arms_run_over_ranks(tmp_path):
    path = tmp_path / "fig5.json"
    torch_fig5.main(["--device", "cpu", "--batches", "2", "--repeats", "1", "--arms", "pc",
                     "--mesh", "none,2", "--json", str(path)])
    validate_bench_json([str(path)])
    payload = json.loads(path.read_text())
    assert payload["config"]["ranks"] == 2
    plain, sharded = payload["records"]
    assert (plain["arm"], sharded["arm"]) == ("pc[earliest,fuse]", "pc[earliest,fuse,mesh2]")
    assert (plain["batch"], plain["mesh"], plain["num_devices"]) == (2, 1, 1)
    assert (sharded["batch"], sharded["per_device_batch"], sharded["mesh"],
            sharded["num_devices"]) == (4, 2, 2, 2)
    assert sharded["grads_per_sec"] > 0 and sharded["vm_steps"] > 0


def test_fig6_mesh_arms_run_over_ranks(tmp_path):
    """A mesh arm's utilization is the unsharded arm's at the same batch;
    a batch the mesh does not divide is a null cell."""
    path = tmp_path / "fig6.json"
    torch_fig6.main(["--device", "cpu", "--batches", "1,2", "--mesh", "none,2",
                     "--json", str(path)])
    validate_bench_json([str(path)])
    odd, even = json.loads(path.read_text())["records"]
    assert even["pc"]["pc[earliest,fuse,mesh2]"] == even["pc"]["pc[earliest,fuse]"] > 0
    assert odd["pc"]["pc[earliest,fuse,mesh2]"] is None and odd["pc"]["pc[earliest,fuse]"] > 0


def test_fig5_pgo_arms_cut_dispatches_and_masked_updates(tmp_path):
    path = tmp_path / "fig5.json"
    torch_fig5.main(["--device", "cpu", "--batches", "2,3", "--repeats", "1", "--arms", "pc",
                     "--pgo", "on,off", "--verify", "--json", str(path)])
    validate_bench_json([str(path)])
    recs = json.loads(path.read_text())["records"]
    assert sorted((r["arm"], r["batch"]) for r in recs) == [
        ("pc[earliest,fuse,pgo]", 2), ("pc[earliest,fuse,pgo]", 3),
        ("pc[earliest,fuse]", 2), ("pc[earliest,fuse]", 3)]
    for z in (2, 3):
        base, opt = (next(r for r in recs if r["batch"] == z and r["pgo"] is p)
                     for p in (False, True))
        assert opt["vm_steps"] < base["vm_steps"]
        assert opt["masked_updates"] < base["masked_updates"]
        assert opt["num_blocks"] < base["num_blocks"]
        assert opt["grads"] == base["grads"]


def test_fig6_has_no_pgo_flag(capsys):
    with pytest.raises(SystemExit):
        torch_fig6.main(["--device", "cpu", "--pgo", "on"])
    assert "unrecognized arguments: --pgo" in capsys.readouterr().err

"""The port's dry-run (``repro_torch.launch.dryrun``), its op counter
(``launch/op_cost.py``), the kernels' cost records and the production
meshes, against the JAX package's dry-run where the two compute the same
arithmetic (the counterpart of tests/test_dryrun.py).

* ``applicable_shapes`` / ``skipped_shapes`` equal the JAX package's for
  every config; ``model_flops_per_chip``, ``bytes_floor_per_chip``,
  ``attn_flash_io_bytes`` and ``default_microbatches`` equal its functions'
  for every (arch, applicable shape) at 256 and 512 chips (exactly: the
  same arithmetic on the same configs).
* The counter: a matmul's FLOPs, a 12-iteration loop counting its body
  12 times (``test_trip_count_multiplies_body``'s counterpart), a
  row-parallel linear on a ``(data 2, model 2)`` fake-group mesh counting a
  quarter of the FLOPs and one all-reduce over ``model``; K3's and K4's
  records on meta tensors (within ``fake.modeling()``) equal to their
  plain versions' counted FLOPs,
  K3's bytes to ``attn_flash_io_bytes``'s per-application model; and the
  flash identity ``bytes(plain) - scope_bytes["attn_core"] + flash_io ==
  bytes(use_flash)`` exactly on a reduced prefill.
* The sLSTM's scan counted per trip on fake tensors (one middle step for
  ``S - 2``, ``op_cost.trips``) equals the same code counted op by op, at
  S = 256 on the 2-layer xLSTM smoke config in bf16, for a prefill and a
  train step under each remat: FLOPs and bytes within 1e-9 relative, op
  and product counts equal, peak bytes within 1 %.
* In a subprocess (the fake group is global to its process, and opening
  it here would leave it to every later test of this worker): both
  production meshes, and ``smollm-135m x decode_32k`` on 32 x 8 end to end.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices;
the fixture initializes JAX first, puts the variable back and checks that
the device count is unchanged.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import fake  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as fd_ref  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.serve.steps import make_prefill_step  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = t_configs.list_archs()
CELLS = dryrun.all_cells()


@pytest.fixture(scope="module")
def j_dryrun():
    devices = jax.device_count()  # JAX is up before the import sets XLA_FLAGS
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    assert jax.device_count() == devices
    return module


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_match_jax(arch):
    t_cfg, j_cfg = t_configs.get_config(arch), j_configs.get_config(arch)
    assert [s.name for s in t_configs.applicable_shapes(t_cfg)] == \
        [s.name for s in j_configs.applicable_shapes(j_cfg)]
    assert t_configs.skipped_shapes(t_cfg) == j_configs.skipped_shapes(j_cfg)
    assert t_configs.SHAPES == {k: t_configs.ShapeSpec(v.name, v.seq_len, v.global_batch, v.kind)
                                for k, v in j_configs.SHAPES.items()}


def _standins(shape):
    """A mesh stand-in for each package: its dims' names and sizes."""
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return (SimpleNamespace(mesh_dim_names=names, shape=shape),
            SimpleNamespace(axis_names=names, devices=np.empty(shape)))


@pytest.mark.parametrize("arch, shape", CELLS)
def test_arithmetic_fields_match_jax(j_dryrun, arch, shape):
    for chips in (256, 512):
        assert dryrun.model_flops_per_chip(arch, shape, chips) == \
            j_dryrun.model_flops_per_chip(arch, shape, chips)
        assert dryrun.bytes_floor_per_chip(arch, shape, chips) == \
            j_dryrun.bytes_floor_per_chip(arch, shape, chips)
        assert dryrun.attn_flash_io_bytes(arch, shape, chips) == \
            j_dryrun.attn_flash_io_bytes(arch, shape, chips)
    for mesh in ((16, 16), (2, 16, 16), (32, 8), (2, 32, 8)):
        t_mesh, j_mesh = _standins(mesh)
        assert dryrun.default_microbatches(arch, shape, t_mesh) == \
            j_dryrun.default_microbatches(arch, shape, j_mesh)


def test_a_matmul_counts_its_flops_and_bytes():
    a, w = torch.randn(8, 16), torch.randn(16, 16)
    _, cost = op_cost.count(lambda a, w: a @ w, a, w)
    assert cost.flops == 2 * 8 * 16 * 16 and cost.dot_count == 1
    assert cost.bytes_accessed == 4 * (8 * 16 + 16 * 16 + 8 * 16)
    assert (cost.argument_bytes, cost.output_bytes) == (4 * (8 * 16 + 16 * 16), 4 * 8 * 16)


def test_a_loop_counts_its_body_every_trip():
    def loop(x, w):
        for _ in range(12):
            x = x @ w
        return x

    _, cost = op_cost.count(loop, torch.randn(8, 16), torch.randn(16, 16))
    assert cost.flops == 4096 * 12 and cost.dot_count == 12


def test_a_scope_counts_its_backward_too():
    x = torch.randn(8, 16)
    w = torch.randn(16, 16, requires_grad=True)
    counter = op_cost.OpCounter()
    with counter:
        with op_cost.scope("s"):
            y = x @ w
        (y @ w).sum().backward()
    cost = counter.close()
    # forward x @ w and its weight gradient x^T @ dy in the scope; the
    # second product and its two gradients outside
    assert cost.scope_flops["s"] == 2 * 4096 and cost.flops == 5 * 4096


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernels_record_their_plain_versions_flops(dtype):
    b, s, h, hk, dh, w = 2, 128, 4, 2, 16, 64
    q, k, v = (torch.randn(b, s, n, dh, dtype=dtype) for n in (h, hk, hk))
    _, plain = op_cost.count(lambda q, k, v: fa_ref.attention(q, k, v, causal=True), q, k, v)
    with fake.modeling():
        _, rec = op_cost.count(lambda q, k, v: fa_ops.flash_attention(q, k, v),
                               *[x.to("meta") for x in (q, k, v)])
    k3 = rec.kernels["flash_attention"]
    assert k3["count"] == 1 and k3["flops"] == plain.flops == rec.flops
    # q, k, v read and o written: attn_flash_io_bytes's model of one
    # application (tokens * dh * (2H + 2Hkv) in the element size)
    assert k3["bytes"] == b * s * dh * (2 * h + 2 * hk) * q.element_size() == rec.bytes_accessed

    qd = torch.randn(b, h, dh, dtype=dtype)
    kc, vc = (torch.randn(b, w, hk, dh, dtype=dtype) for _ in range(2))
    count = torch.tensor([0, w], dtype=torch.int32)
    _, plain = op_cost.count(fd_ref.decode_attention, qd, kc, vc, count)
    with fake.modeling():
        _, rec = op_cost.count(fd_ops.decode_attention,
                               *[x.to("meta") for x in (qd, kc, vc, count)])
    k4 = rec.kernels["decode_attention"]
    assert k4["count"] == 1 and k4["flops"] == plain.flops == rec.flops
    # a meta count has no values: the whole window's rows are charged
    assert k4["bytes"] == 2 * b * h * dh * qd.element_size() + 4 * b \
        + 2 * b * w * hk * dh * qd.element_size()


def test_flash_identity_on_a_reduced_prefill():
    """The dry-run's ``t_memory_flash`` model is exact in the port:
    swapping the blocked attention for K3 changes the bytes by the
    ``attn_core`` scope less K3's q/k/v/o streams, nothing else."""
    cfg = t_configs.reduce_for_smoke(t_configs.get_config("smollm-135m"))
    cfg = type(cfg)(**{**cfg.__dict__, "compute_dtype": "bfloat16", "attn_q_chunk": 32})
    b, s = 2, 128
    costs = {}
    params = fake.build_meta(
        lambda: get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)))
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    with fake.modeling():
        for flash in (False, True):
            step = make_prefill_step(get_model(cfg, use_flash=flash, device="meta"))
            costs[flash] = op_cost.count(step, params, batch)[1]
    flash_io = cfg.num_layers * b * s * cfg.resolved_head_dim * (
        2 * cfg.num_heads + 2 * cfg.num_kv_heads) * 2
    plain, fl = costs[False], costs[True]
    assert plain.bytes_accessed - plain.scope_bytes["attn_core"] + flash_io == fl.bytes_accessed
    assert fl.scope_bytes["attn_core"] == flash_io
    assert fl.kernels["flash_attention"]["count"] == cfg.num_layers
    assert "flash_attention" not in plain.kernels
    assert fl.flops == plain.flops  # K3 records its plain version's products


def _xlstm_cost(kind: str, remat: str, s: int = 256, b: int = 2) -> op_cost.Cost:
    """A prefill or a train step of the 2-layer xLSTM smoke config (one
    mLSTM, one sLSTM) in bf16 on meta tensors, counted."""
    cfg = t_configs.reduce_for_smoke(t_configs.get_config("xlstm-350m"))
    cfg = type(cfg)(**{**cfg.__dict__, "compute_dtype": "bfloat16"})
    assert cfg.num_layers == 2 and "slstm" in cfg.xlstm_pattern
    params = fake.build_meta(
        lambda: get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)))
    model = get_model(cfg, device="meta")
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    with fake.modeling():
        if kind == "prefill":
            with torch.no_grad():
                return op_cost.count(make_prefill_step(model), params, {"tokens": tokens})[1]
        tcfg = ts.TrainConfig(microbatches=1, remat=remat, opt=opt_lib.OptimizerConfig())
        return op_cost.count(ts.make_train_step(model, tcfg), params,
                             opt_lib.init_opt_state(params, tcfg.opt), {"tokens": tokens})[1]


@pytest.mark.parametrize("kind,remat", [("prefill", None), ("train", "full"),
                                        ("train", "none")])
def test_slstm_scan_per_trip_counts_as_op_by_op(monkeypatch, kind, remat):
    """The dry-run's per-trip count of the sLSTM scan (its first and last
    steps, and one middle step standing for the other S - 2) against the
    same code run every trip on fake tensors."""
    per_trip = []
    scan = X._scan_per_trip
    monkeypatch.setattr(X, "_scan_per_trip", X._scan_steps)
    want = _xlstm_cost(kind, remat)
    monkeypatch.setattr(X, "_scan_per_trip", lambda *a: per_trip.append(1) or scan(*a))
    got = _xlstm_cost(kind, remat)
    assert per_trip  # (remat="full" runs the layer again in the backward pass)
    assert got.flops == pytest.approx(want.flops, rel=1e-9)
    assert got.bytes_accessed == pytest.approx(want.bytes_accessed, rel=1e-9)
    assert (got.op_count, got.dot_count) == (want.op_count, want.dot_count)
    assert got.peak_bytes == pytest.approx(want.peak_bytes, rel=0.01)
    assert (got.argument_bytes, got.output_bytes) == (want.argument_bytes, want.output_bytes)


def test_trips_count_a_loop_body_and_its_backward_n_times():
    """One trip under ``trips(12)`` counts as the 12-trip loop above, its
    weight gradient too; what it leaves live counts 12 times once held."""
    x = torch.randn(8, 16)
    w = torch.randn(16, 16, requires_grad=True)
    counter = op_cost.OpCounter()
    with counter:
        with op_cost.trips(12) as trip:
            y = x @ w
        trip.hold()
        live = counter._live_bytes
        y.sum().backward()
    cost = counter.close()
    # forward x @ w and its weight gradient x^T @ dy, 12 times each
    assert cost.flops == 2 * 4096 * 12 and cost.dot_count == 24
    assert live >= 12 * 8 * 16 * 4  # y, held for 12 trips


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "worker.json"
    proc = subprocess.run(
        [sys.executable, "-m", "tests.torch_dryrun_workers", str(out)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])},
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_a_sharded_linear_counts_one_ranks_work(production):
    lin = production["linear"]
    assert lin["flops"] == lin["unsharded_flops"] / 4
    assert lin["collectives"] == {"all-reduce": {"count": 1, "bytes": 4 * 4 * 32, "dims": {
        "model": {"count": 1, "bytes": 4 * 4 * 32}}}}


def test_production_meshes(production):
    assert production["meshes"] == {
        "False": [[32, 8], ["data", "model"], 256],
        "True": [[2, 32, 8], ["pod", "data", "model"], 512]}


def test_smallest_production_cell_end_to_end(production):
    """The counterpart of TestDryRunSubprocess: SmolLM-135M's decode step
    on 32 x 8, with the record's fields."""
    cell = production["cell"]
    assert (cell["chips"], cell["mesh"], cell["step"]) == (256, "32x8", "serve_step")
    assert cell["bottleneck"] in ("compute", "memory", "collective")
    assert cell["peak_bytes"] > 0 and cell["fits"]
    assert cell["peak_bytes"] == cell["argument_bytes"] + cell["temp_bytes"]
    for field, fn in (("model_flops", dryrun.model_flops_per_chip),
                      ("bytes_floor", dryrun.bytes_floor_per_chip)):
        assert cell[field] == fn("smollm-135m", "decode_32k", 256)
    layers = t_configs.get_config("smollm-135m").num_layers
    k4 = cell["kernels"]["decode_attention"]
    assert k4["count"] == layers and cell["scope_bytes"]["attn_core"] == k4["bytes"]
    assert cell["collective_bytes"] > 0 and "t_memory_flash" in cell

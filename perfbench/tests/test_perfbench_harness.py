"""The harness rehearsed on the CPU at a tiny size: a run's result line, the
absence of JAX, the comparison catching each fault a NUTS cell can have,
the controls, and the trace's reduction."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench import run as bench

from .conftest import ROOT, small

SEED = 2**31 + 5


def _execute(cell, trace=False, make_kernel=None, device="cpu", overrides=None):
    return bench.execute(cell, SEED, 0.1, trace, device=device, make_kernel=make_kernel,
                         overrides=small(cell) if overrides is None else overrides)


@pytest.mark.parametrize("cell", ["nuts-logreg.local-wide", "nuts-logreg.pc-wide"])
def test_rehearsal_is_correct(cell):
    res = _execute(cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"grads_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 2 * 16 and res["failed"] == 0
    traced = _execute(cell, trace=True)
    assert traced["correct"]
    assert "grad_utilization" in traced["metrics"]
    assert "device_idle" not in traced["metrics"]  # no device trace on the CPU


def test_rehearsal_loads_no_jax():
    code = (
        "import sys, json; sys.path[:0] = [{src!r}, {root!r}]\n"
        "from perfbench import run, harness\n"
        "from perfbench.tests.conftest import small\n"
        "res = run.execute('nuts-logreg.local-wide', 7, 0.1, False, device='cpu',"
        " overrides=small('nuts-logreg.local-wide'))\n"
        "print(json.dumps([res['correct'], sorted({{m.split('.')[0] for m in sys.modules}})]))\n"
    ).format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    assert "repro_torch" in tops
    for bad in ("jax", "jaxlib", "flax", "repro", "benchmarks", "tools", "chip_smoke"):
        assert bad not in tops


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "nuts-logreg.pc-wide", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


class _Faulty:
    """The port's kernel with a fault planted under it."""

    def __init__(self, kernel, fault):
        self._k, self._fault = kernel, fault

    def __getattr__(self, name):
        return getattr(self._k, name)

    def stepper(self, *args):
        return self._k.stepper(*args)

    def __call__(self, theta, eps, keys):
        if self._fault == "unchanged":
            self._k(theta, eps, keys)
            return {"theta": theta.clone(), "sum_theta": theta * 0, "sum_sq": theta * 0}
        out = self._k(theta, eps, keys)
        if self._fault == "half_batch":
            h = theta.shape[0] // 2
            out = {n: v.clone() for n, v in out.items()}
            out["theta"][h:] = theta[h:]
            out["sum_theta"][h:] = 0
            out["sum_sq"][h:] = 0
        elif self._fault == "altered":
            out = dict(out, theta=out["theta"] * (1 + 1e-2))
        return out


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["nuts-logreg.pc-wide", "nuts-logreg.local-wide"])
def test_faults_are_caught(cell, fault):
    from repro_torch.mcmc import nuts

    def make(*a, **kw):
        return _Faulty(nuts.make_nuts_kernel(*a, **kw), fault)

    res = _execute(cell, make_kernel=make)
    assert not res["correct"], res["checks"]


def _control(cell, device, kind=None):
    """The comparison's verdict on the reference computed one precision
    below the configuration's, put in the program's place."""
    from perfbench import calibrate
    from perfbench.reference import compare

    got = []
    over = small(cell)
    if kind:
        over["config"] = {**over["config"], "control": kind}
    bench.execute(cell, SEED, 0.1, False, device=device, overrides=over, outcome=got)
    out = got[0]
    out.extra["seed"] = SEED
    c = harness.resolve(harness.load_manifest(), cell)
    c.config = {**c.config, **over["config"]}
    c.traffic = {**c.traffic, **over["traffic"]}
    values = calibrate.control_numbers(c, out, torch.device(device), c.traffic["chains"])
    return compare.judge(values, c.config["limits"])[0], values


def test_bfloat16_control_fails_on_the_cpu():
    # TF32, the configuration's control, exists only on the card; bfloat16
    # stands in here to hold the comparison to a lower precision.
    ok, values = _control("nuts-logreg.pc-wide", "cpu", kind="bfloat16")
    assert not ok, values


@pytest.mark.cuda
def test_tf32_control_fails(cuda_device):
    ok, values = _control("nuts-logreg.pc-wide", cuda_device)
    assert not ok, values


def test_trace_reduction():
    t = harness.Trace(ops=[("gemm", 10, 20), ("gemm", 15, 30), ("add", 50, 60)],
                      scopes=[("perfbench.call", 0, 100), ("pcvm.block1", 5, 40),
                              ("pcvm.block2", 45, 70)], t0=0, t1=110)
    assert t.busy_s() == pytest.approx(30e-9)
    assert t.top_ops() == [["gemm", 25e-9], ["add", 10e-9]]
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"perfbench.call": 40e-9, "pcvm.block1": 15e-9,
                                  "pcvm.block2": 15e-9, "host": 10e-9})

"""Fault-injected open-loop serving on the port (``tools/torch_chaos.py``
``ChaosModel`` and ``benchmarks/torch_serve_bench.py --chaos``) against
the JAX package's (``tools/chaos.py``, ``benchmarks/serve_bench.py``), on
the float32 SmolLM-135M smoke config with the JAX weights carried across.

* ``chaos_requests`` draws the JAX benchmark's stream exactly: rids,
  arrivals, prompts and the injected map, over seeds and chaos rates;
* ``ChaosModel.decode_step`` on the same weights and tokens (both
  sentinels among them, EOS forced on some lanes), with the compute-dtype
  and the int8 cache: logits within ``TOL`` (float32, the sums of two
  libraries) and every cache leaf's NaN pattern equal, the int8 leaves
  untouched;
* a chaos serve at 2 lanes under a virtual clock: the calibrated watchdog
  budget equal, and per request the status, fault, attempts, lane and
  tokens equal;
* the CLI's sweep on the CPU gives no violation and strict JSON, and
  ``main`` exits 1 when a record carries one.

The JAX side (models, engines) is made once, in module-scoped fixtures.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import serve_bench as j_bench  # noqa: E402
from benchmarks import torch_serve_bench as t_bench  # noqa: E402
from benchmarks.common import validate_bench_json  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from tests import torch_parity as tp  # noqa: E402
from tools import chaos as j_chaos  # noqa: E402
from tools import torch_chaos as t_chaos  # noqa: E402

ARCH = "smollm-135m"
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT_LEN, MAX_NEW = 6, 64  # the JAX sweep's defaults
EOS_POS = PROMPT_LEN + 2
KNOBS = dict(on_fault="quarantine", detect_nonfinite=True, max_attempts=2,
             retry_backoff_s=0.0)


@pytest.fixture(scope="module")
def lm():
    return tp.carry(ARCH)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("chaos_rate", [0.2, 0.5])
def test_chaos_requests_equal_the_jax_stream(seed, chaos_rate):
    got, got_inj = t_bench.chaos_requests(40, 32.0, chaos_rate, PROMPT_LEN, 256, seed)
    want, want_inj = j_bench.chaos_requests(40, 32.0, chaos_rate, PROMPT_LEN, 256, seed)
    assert got_inj == want_inj and len(got_inj) == max(round(40 * chaos_rate), 2)
    assert [(r.rid, r.arrival) for r in got] == [(r.rid, r.arrival) for r in want]
    for g, w in zip(got, want):
        assert g.prompt.dtype == np.int32
        np.testing.assert_array_equal(g.prompt, w.prompt)


@pytest.mark.parametrize("kv_cache_dtype", ["compute", "int8"])
def test_chaos_model_decode_step_matches_jax(kv_cache_dtype):
    c = tp.carry(ARCH, kv_cache_dtype=kv_cache_dtype)
    vocab = c["cfg"].vocab_size
    jcm = j_chaos.ChaosModel(c["jm"], eos_pos=4)
    tcm = t_chaos.ChaosModel(c["model"], eos_pos=4)
    assert (tcm.nan_token, tcm.slow_token) == (jcm.nan_token, jcm.slow_token)
    # Lanes: healthy, NaN sentinel, livelock sentinel, healthy; positions
    # cross eos_pos on the way, so EOS is forced on the healthy lanes.
    tokens = np.array([[3, vocab - 1, vocab - 2, 9], [17, 5, vocab - 2, 11],
                       [4, 6, vocab - 2, vocab - 1]], np.int32)
    jcache, tcache = jcm.init_cache(4, 8), tcm.init_cache(4, 8)
    jstep = jax.jit(jcm.decode_step)
    for step, toks in enumerate(tokens):
        pos = np.array([step, step + 1, step + 2, step + 3], np.int32)
        jl, jcache = jstep(c["jparams"], jcache, jnp.asarray(toks), jnp.asarray(pos))
        tl, tcache = tcm.decode_step(c["params"], tcache, torch.from_numpy(toks),
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {step}", **TOL)
        got, want = tp.leaves(tcache), tp.leaves(jcache)
        assert got.keys() == want.keys()
        for k in want:
            g, w = got[k].astype(np.float32), want[k].astype(np.float32)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{k} step {step}")
            if np.issubdtype(want[k].dtype, np.integer):
                assert not np.isnan(g).any()
    # The NaN lane (1 at step 0, 3 at step 2) is poisoned, no other is.
    kv = tcache["kv"]
    for name, leaf in kv.items():
        lanes = leaf.float().isnan().flatten(2).any(dim=2).any(dim=0)
        want = [False, True, False, True] if leaf.is_floating_point() else [False] * 4
        assert lanes.tolist() == want, name


def _ecfg(mod, lanes: int, **kw):
    return mod.EngineConfig(lanes=lanes, max_context=PROMPT_LEN + MAX_NEW + 2,
                            max_prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW,
                            requests_per_lane=1, eos_id=0, segment_steps=8, **KNOBS, **kw)


def _clock(tick: float):
    t = {"now": 0.0}

    def now():
        t["now"] += tick
        return t["now"]

    return now


def test_chaos_serve_matches_the_jax_engine(lm):
    """The JAX sweep's calibration and one chaos cell, on a virtual clock."""
    jcm = j_chaos.ChaosModel(lm["jm"], eos_pos=EOS_POS)
    tcm = t_chaos.ChaosModel(lm["model"], eos_pos=EOS_POS)
    budgets = []
    for mod, model, params in ((j_engine, jcm, lm["jparams"]), (t_engine, tcm, lm["params"])):
        cal = mod.GenerationEngine(model, params, _ecfg(mod, 1))
        _, stats = cal.serve([mod.Request(rid=0, prompt=np.full((PROMPT_LEN,), 1, np.int32))])
        budgets.append(2 * stats.vm_steps)
    assert budgets[0] == budgets[1] > 0
    reqs, injected = j_bench.chaos_requests(8, 32.0, 0.2, PROMPT_LEN, lm["cfg"].vocab_size, 0)
    out = []
    for mod, model, params in ((j_engine, jcm, lm["jparams"]), (t_engine, tcm, lm["params"])):
        eng = mod.GenerationEngine(model, params, _ecfg(mod, 2, lane_step_budget=budgets[0]))
        out.append(eng.serve([mod.Request(r.rid, r.prompt, r.arrival) for r in reqs],
                             now_fn=_clock(0.01)))
    (j_comps, j_stats), (t_comps, t_stats) = out
    assert len(t_comps) == len(j_comps) == len(reqs)
    for j, t in zip(j_comps, t_comps):
        for f in ("rid", "status", "fault", "attempts", "lane"):
            assert getattr(t, f) == getattr(j, f), (t.rid, f)
        np.testing.assert_array_equal(t.tokens, j.tokens)
    for f in ("ok", "faulted", "timeout", "rejected", "retries", "vm_steps", "segments"):
        assert getattr(t_stats, f) == getattr(j_stats, f), f
    # Every injected request was contained, with its own fault kind.
    by = {c.rid: c for c in t_comps}
    assert injected and all((by[rid].status, by[rid].fault) == ("faulted", kind)
                            for rid, kind in injected.items())


def test_chaos_cli_runs_clean_on_the_cpu(tmp_path):
    path = tmp_path / "chaos.json"
    rc = t_bench.main(["--device", "cpu", "--chaos", "--lanes", "2", "--num-requests", "8",
                       "--rate", "32", "--segment-steps", "8", "--json", str(path)])
    assert rc == 0
    validate_bench_json([str(path)])
    payload = json.loads(path.read_text())
    assert payload["config"]["chaos"] and payload["config"]["chaos_rate"] == 0.2
    (rec,) = payload["records"]
    assert rec["violations"] == [] and rec["healthy_bitexact"]
    assert rec["device"]["type"] == "cpu"
    assert (rec["max_new"], rec["prompt_len"]) == (MAX_NEW, PROMPT_LEN)
    assert sum(rec["statuses"].values()) == 8
    assert rec["lane_step_budget"] == 2 * rec["calibration"]["vm_steps"]
    assert {k: v for k, v in rec["faults"].items() if k in rec["injected_rids"]} \
        == rec["injected_rids"]
    for key in ("error_rate", "retry_rate", "shed_rate", "timeout_rate", "injected"):
        assert key in rec


def test_chaos_cli_exits_1_on_a_violation(monkeypatch, tmp_path, capsys):
    def planted(*args, **kwargs):
        tab = t_bench.Table("planted", ["lanes"])
        return tab, [{"mode": "chaos", "lanes": 2, "violations": ["planted violation"]}]

    monkeypatch.setattr(t_bench, "chaos_sweep", planted)
    rc = t_bench.main(["--device", "cpu", "--chaos", "--json", str(tmp_path / "c.json")])
    assert rc == 1
    assert "[VIOLATION] planted violation" in capsys.readouterr().out

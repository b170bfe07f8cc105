"""The port's closed-loop generation engine (``repro_torch.serve.engine``)
against the JAX package's ``GenerationEngine.generate`` on the cases of
tests/test_serve.py, on the float32 SmolLM-135M smoke config with the
JAX weights carried across: the oracle match, divergent queue depths,
skewed prompt lengths, empty prompts and zero-request lanes.

Tokens and lengths must be equal, and so must what the VM reports of the
run: ``utilization["decode"]``, the number of lowered blocks, and that the
loop-only program has no variable stacks.  The port's own sequential
oracle (``reference_generate``) must agree too.  The JAX side runs once,
in a module-scoped fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.engine import GenerationEngine as JGenerationEngine  # noqa: E402
from repro_torch import configs, distributed, interop  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve.engine import EngineConfig, GenerationEngine, _cache_layout  # noqa: E402
from repro_torch.testing import engine_inputs  # noqa: E402
from tests import torch_mesh_workers as workers  # noqa: E402

ARCH = "smollm-135m"


def _case_inputs():
    """name -> (engine config fields, prompts, prompt lengths, n_req list);
    the inputs of tests/test_serve.py's cases, drawn the same way."""
    cases = {}
    kw = dict(lanes=4, max_context=32, max_prompt_len=6, max_new_tokens=8,
              requests_per_lane=2, eos_id=0)
    prompts, plens = engine_inputs(EngineConfig(**kw), 256, seed=0)
    cases["oracle"] = (kw, prompts, plens, [None])
    kw = dict(lanes=4, max_context=32, max_prompt_len=5, max_new_tokens=4,
              requests_per_lane=3, eos_id=0)
    prompts, plens = engine_inputs(EngineConfig(**kw), 256, seed=1, min_len=1)
    cases["divergent_queues"] = (kw, prompts, plens, [np.array([3, 1, 2, 3], np.int32)])
    kw = dict(lanes=8, max_context=32, max_prompt_len=8, max_new_tokens=6,
              requests_per_lane=1, eos_id=0)
    prompts, plens = engine_inputs(EngineConfig(**kw), 256, seed=2, min_len=1)
    cases["skewed_prompts"] = (kw, prompts, plens, [None])
    kw = dict(lanes=3, max_context=32, max_prompt_len=5, max_new_tokens=6,
              requests_per_lane=2, eos_id=0)
    prompts, _ = engine_inputs(EngineConfig(**kw), 256, seed=3)
    plens = np.array([[0, 3], [2, 0], [0, 0]], np.int32)  # first, last, a whole lane
    cases["empty_prompts"] = (kw, prompts, plens, [None])
    kw = dict(lanes=2, max_context=32, max_prompt_len=4, max_new_tokens=4,
              requests_per_lane=2, eos_id=0)
    prompts, plens = engine_inputs(EngineConfig(**kw), 256, seed=4, min_len=1)
    cases["zero_request_lanes"] = (kw, prompts, plens,
                                   [np.array([2, 0], np.int32), np.zeros(2, np.int32)])
    return cases


CASES = _case_inputs()


@pytest.fixture(scope="module")
def lm():
    jcfg = j_configs.get_smoke_config(ARCH)
    jm = j_get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config(ARCH)
    assert cfg.vocab_size == 256
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jm, params, get_model(cfg, device="cpu"), tparams


@pytest.fixture(scope="module")
def jax_runs(lm):
    """case -> [(tokens, lengths, decode utilization, block count)] from the
    JAX package's engine, one entry per n_req."""
    jm, params, _, _ = lm
    runs = {}
    for name, (kw, prompts, plens, n_reqs) in CASES.items():
        eng = JGenerationEngine(jm, params, JEngineConfig(**kw, backend="pc"))
        runs[name] = []
        for n_req in n_reqs:
            res = eng.generate(prompts, plens, n_req=n_req)
            runs[name].append((res["tokens"], res["lengths"], res["utilization"],
                               len(eng.batched.lowered.blocks)))
    return runs


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(lm, jax_runs, case):
    _, _, model, params = lm
    kw, prompts, plens, n_reqs = CASES[case]
    eng = GenerationEngine(model, params, EngineConfig(**kw))
    for n_req, (tokens, lengths, util, n_blocks) in zip(n_reqs, jax_runs[case]):
        res = eng.generate(prompts, plens, n_req=n_req)
        np.testing.assert_array_equal(res["tokens"], tokens)
        np.testing.assert_array_equal(res["lengths"], lengths)
        assert res["utilization"] == pytest.approx(util, rel=1e-12)
        assert len(eng.batched.lowered.blocks) == n_blocks
        assert eng.batched.lowered.stack_vars == frozenset()
        oracle = eng.reference_generate(prompts, plens, n_req=n_req)
        np.testing.assert_array_equal(oracle["tokens"], tokens)
        np.testing.assert_array_equal(oracle["lengths"], lengths)


def test_edge_case_semantics(lm, jax_runs):
    """Empty prompts give empty completions; lanes with no requests stay zero."""
    tokens, lengths, *_ = jax_runs["empty_prompts"][0]
    assert lengths[0, 0] == 0 and (tokens[2] == 0).all() and (lengths[2] == 0).all()
    tokens, lengths, *_ = jax_runs["divergent_queues"][0]
    assert lengths[1, 1] == 0 and lengths[2, 2] == 0
    for tokens, lengths, *_ in jax_runs["zero_request_lanes"]:
        assert (tokens[1] == 0).all() and (lengths[1] == 0).all()


def test_cache_layout_finds_the_lane_axis(lm):
    _, _, model, _ = lm
    _, axes, specs = _cache_layout(model, 32)
    cfg = model.cfg
    assert axes == [1, 1]
    assert [s.shape for s in specs] == [(cfg.num_layers, 32, cfg.num_kv_heads,
                                         cfg.resolved_head_dim)] * 2


def test_cache_layout_rejects_an_ambiguous_leaf():
    class BadModel:
        def init_cache(self, batch, window, device=None):
            return {"kv": {"k": torch.zeros((batch, batch, window), device=device)}}

    with pytest.raises(ValueError, match=r"ambiguous batch axis for cache leaf"):
        _cache_layout(BadModel(), 8)


def test_engine_options_reach_the_vm(lm, tmp_path):
    """Checkpoints, tracing and lane sharding reach the engine's VM.  A mesh
    is resolved at the first call: lanes that do not divide across it are
    refused at once, and mesh=2 with no ranks running raises rather than
    serving on one device.  (Crash-resume: tests/test_torch_serve_open.py;
    the sharded engine: test_sharded_generate_matches_unsharded_and_jax.)"""
    _, _, model, params = lm
    kw = dict(lanes=2, max_context=16, max_prompt_len=4, max_new_tokens=4,
              requests_per_lane=1)
    eng = GenerationEngine(model, params, EngineConfig(**kw, checkpoint_dir=str(tmp_path)))
    assert eng.cfg.checkpoint_dir == str(tmp_path) and eng.cfg.checkpoint_every_segments == 8
    assert GenerationEngine(model, params, EngineConfig(**kw, trace=64)).batched.trace == 64
    eng = GenerationEngine(model, params, EngineConfig(**kw, mesh=2))
    assert eng.batched.mesh == 2
    with pytest.raises(ValueError, match="no torch.distributed process group"):
        eng.generate(np.ones((2, 1, 4), np.int32), np.ones((2, 1), np.int32))
    with pytest.raises(ValueError, match="divide"):
        GenerationEngine(model, params, EngineConfig(**dict(kw, lanes=3), mesh=2))
    with pytest.raises(ValueError, match="pc backend"):
        GenerationEngine(model, params, EngineConfig(**kw, mesh=2, backend="local"))


@pytest.fixture(scope="module")
def sharded_generate(lm, tmp_path_factory):
    """The divergent-queues case with its four lanes over two gloo ranks."""
    _, params, _, _ = lm
    kw, prompts, plens, (n_req,) = CASES["divergent_queues"]
    return distributed.spawn(
        workers.engine_generate, 2, backend="gloo", devices=["cpu"] * 2, timeout=300,
        args=(jax.tree.map(np.asarray, params), kw, prompts, plens, n_req),
        rendezvous_dir=tmp_path_factory.mktemp("ranks"))


def test_sharded_generate_matches_unsharded_and_jax(lm, jax_runs, sharded_generate):
    """Lanes as independent request queues over two ranks: every rank gets
    the JAX engine's tokens, lengths and decode utilization, the unsharded
    port's too, with two lanes a rank."""
    _, _, model, params = lm
    kw, prompts, plens, (n_req,) = CASES["divergent_queues"]
    ((tokens, lengths, util, _),) = jax_runs["divergent_queues"]
    plain = GenerationEngine(model, params, EngineConfig(**kw)).generate(prompts, plens,
                                                                         n_req=n_req)
    for r in sharded_generate:
        np.testing.assert_array_equal(r["tokens"], tokens)
        np.testing.assert_array_equal(r["lengths"], lengths)
        np.testing.assert_array_equal(r["tokens"], plain["tokens"])
        assert r["utilization"] == pytest.approx(util, rel=1e-12) == plain["utilization"]
        assert (r["num_devices"], r["local_lanes"]) == (2, 2)

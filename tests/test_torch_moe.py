"""The port's MoE family (``repro_torch.models.moe`` and the ``moe``
branches of ``models.transformer``) against the JAX package on the float32
smoke configs of DeepSeek-MoE-16B (a leading dense layer, a shared expert,
raw top-k weights) and Qwen3-MoE-235B-A22B (renormalized top-k, no shared
expert, ``qk_norm``), with the JAX weights carried across.

Trees, forward logits and ``moe_aux_loss``, loss and every gradient leaf,
20 decode steps past a 16-slot window (logits and cache), the MoE FFN and
its router, tied router probabilities (the lower expert first, as
``jax.lax.top_k`` orders them), the dispatch at capacities that drop assignments (the dropped
set equal exactly: an assignment is dropped where the output's gradient
with respect to its combine weight is exactly zero, in both packages), and
the serving engine at 4 lanes against the JAX engine.  Tolerances are in
tests/torch_parity.py.  The JAX side runs once per config, in a
module-scoped fixture.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

from repro.models import moe as J_MOE  # noqa: E402
from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.engine import GenerationEngine as JGenerationEngine  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.serve.engine import EngineConfig, GenerationEngine  # noqa: E402
from repro_torch.testing import engine_inputs  # noqa: E402
from tests import torch_parity as tp  # noqa: E402

ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
CAPACITIES = (2, 5)  # of 16 tokens x top-2 over 4 experts: most, then a few dropped


def _unit_inputs(cfg):
    rng = np.random.default_rng(3)
    return rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)


def _jax_units(c: dict) -> dict:
    jcfg = c["jcfg"]
    p = jax.tree.map(lambda t: t[0], c["jparams"]["layers"])["moe"]
    x = jnp.asarray(_unit_inputs(jcfg))
    xf = x.reshape(-1, jcfg.d_model)
    y, aux = J_MOE.moe_ffn(p, x, jcfg)
    top_p, top_e, raux = J_MOE.router_probs(p, xf, jcfg)
    drops = {}
    for cap in CAPACITIES:
        def total(w, cap=cap):
            out, a = J_MOE._dispatch_compute_combine(p, x, xf, w, top_e, raux, cap, jcfg)
            return jnp.sum(out), (out, a["moe_dropped_frac"])
        grad, (out, frac) = jax.grad(total, has_aux=True)(top_p)
        drops[cap] = (np.asarray(out), float(frac), np.asarray(grad))
    return dict(ffn=(np.asarray(y), jax.tree.map(np.asarray, aux)),
                router=(np.asarray(top_p), np.asarray(top_e), float(raux["moe_aux_loss"])),
                drops=drops)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    c = tp.carry(request.param)
    c["jax"] = tp.jax_results(c)
    c["units"] = _jax_units(c)
    c["lp"] = pytree.tree_map(lambda t: t[0], c["params"]["layers"]["moe"])
    return c


def test_init_and_cache_make_the_jax_trees(fam):
    model = fam["model"]
    own = model.init(torch.Generator().manual_seed(0))
    tp.assert_same_tree(own, fam["jparams"])
    assert isinstance(own["dense_layers"], list)
    assert len(own["dense_layers"]) == fam["cfg"].first_dense_layers
    tp.assert_same_tree(model.init_cache(3, 8), fam["jax"]["cache3"])


def test_forward_and_aux_loss_match_jax(fam):
    logits, aux = fam["model"].forward(fam["params"], {"tokens": torch.from_numpy(fam["tokens"])})
    tp.close(logits, fam["jax"]["logits"])
    assert aux.keys() == fam["jax"]["aux"].keys() == {"moe_aux_loss"}
    tp.close(aux["moe_aux_loss"], fam["jax"]["aux"]["moe_aux_loss"])
    assert float(aux["moe_aux_loss"]) > 0


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_grads_match_jax(fam, remat):
    (loss, aux), grads = tp.port_loss_and_grads(fam, remat)
    np.testing.assert_allclose(float(loss), fam["jax"]["loss"], **tp.LOSS_TOL)
    for k in ("ce", "moe_aux_loss"):
        np.testing.assert_allclose(float(aux[k]), float(fam["jax"]["laux"][k]), **tp.LOSS_TOL)
    tp.assert_grads_close(grads, fam["jax"]["grads"])


def test_decode_steps_match_jax_logits_and_cache(fam):
    logits, cache = tp.port_decode(fam)
    tp.close(logits, fam["jax"]["decode"])
    tp.assert_trees_close(cache, fam["jax"]["cache"])


def test_moe_ffn_and_router_match_jax(fam):
    cfg, x = fam["cfg"], torch.from_numpy(_unit_inputs(fam["cfg"]))
    y, aux = MOE.moe_ffn(fam["lp"], x, cfg)
    want_y, want_aux = fam["units"]["ffn"]
    tp.close(y, want_y)
    assert aux.keys() == want_aux.keys() == {"moe_aux_loss", "moe_dropped_frac"}
    for k in aux:
        tp.close(aux[k], want_aux[k])
    top_p, top_e, raux = MOE.router_probs(fam["lp"], x.reshape(-1, cfg.d_model), cfg)
    want_p, want_e, want_aux_loss = fam["units"]["router"]
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    tp.close(top_p, want_p)
    tp.close(raux["moe_aux_loss"], want_aux_loss)


@pytest.mark.parametrize("router", ["layer", "equal-columns", "zero-64x6"])
def test_tied_probabilities_route_to_the_lower_experts_as_in_jax(fam, router):
    """An all-zero token (uniform router probabilities) under the layer's
    router, every token under a router of equal columns, and every token
    over 64 experts, top 6, under a zero router: ``jax.lax.top_k`` puts the
    lower expert first among equal probabilities, and so must the port.
    The expert ids equal exactly; the weights, the dispatch's output and its
    gradient with respect to the weights within ``TOL``."""
    cfg, jcfg = fam["cfg"], fam["jcfg"]
    x = _unit_inputs(cfg)
    x[0, 0] = 0.0
    lp = dict(fam["lp"])
    jlp = dict(jax.tree.map(lambda t: t[0], fam["jparams"]["layers"])["moe"])
    if router == "equal-columns":
        lp["router"] = lp["router"][:, :1].expand(-1, cfg.num_experts).contiguous()
        jlp["router"] = jnp.asarray(lp["router"].numpy())
    elif router == "zero-64x6":
        cfg = dataclasses.replace(cfg, num_experts=64, top_k=6)
        jcfg = dataclasses.replace(jcfg, num_experts=64, top_k=6)
        lp = {"router": torch.zeros((cfg.d_model, 64))}
        jlp = {"router": jnp.zeros((cfg.d_model, 64))}
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    top_p, top_e, _ = MOE.router_probs(lp, xf, cfg)
    want_p, want_e, want_aux = J_MOE.router_probs(jlp, jnp.asarray(xf.numpy()), jcfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want_e))
    tp.close(top_p, want_p)
    tied = np.arange(cfg.top_k) if router != "layer" else np.asarray(want_e)[0]
    np.testing.assert_array_equal(top_e[0].numpy(), tied)
    if router == "zero-64x6":
        return
    cap = MOE.expert_capacity(xf.shape[0], cfg)
    w = top_p.detach().requires_grad_(True)
    out, _ = MOE._dispatch_compute_combine(lp, torch.from_numpy(x), xf, w, top_e,
                                           {"moe_aux_loss": 0.0}, cap, cfg)
    (grad,) = torch.autograd.grad(out.sum(), w)

    def total(wj):
        o, _ = J_MOE._dispatch_compute_combine(jlp, jnp.asarray(x), jnp.asarray(xf.numpy()), wj,
                                               want_e, want_aux, cap, jcfg)
        return jnp.sum(o), o

    want_grad, want_out = jax.grad(total, has_aux=True)(want_p)
    tp.close(out, want_out)
    tp.close(grad, want_grad)


@pytest.mark.parametrize("cap", CAPACITIES)
def test_dispatch_drops_exactly_the_assignments_jax_drops(fam, cap):
    cfg, x = fam["cfg"], torch.from_numpy(_unit_inputs(fam["cfg"]))
    xf = x.reshape(-1, cfg.d_model)
    top_p, top_e, raux = MOE.router_probs(fam["lp"], xf, cfg)
    w = top_p.detach().requires_grad_(True)
    out, aux = MOE._dispatch_compute_combine(fam["lp"], x, xf, w, top_e, raux, cap, cfg)
    (grad,) = torch.autograd.grad(out.sum(), w)
    want_out, want_frac, want_grad = fam["units"]["drops"][cap]
    dropped, want_dropped = grad.numpy() == 0, want_grad == 0
    assert 0 < want_dropped.sum() < want_dropped.size
    np.testing.assert_array_equal(dropped, want_dropped)
    assert float(aux["moe_dropped_frac"]) == want_frac == want_dropped.mean()
    tp.close(out, want_out)


@pytest.mark.parametrize("fam", ["deepseek-moe-16b"], indirect=True)
def test_engine_matches_the_jax_engine_at_four_lanes(fam):
    """The decode step is one batched primitive over every lane, so the
    capacity, and with it what drops, depends on the lane count: the port's
    engine is held to the JAX engine at the same 4 lanes (tokens,
    lengths, dispatches, decode executions), and to its own oracle."""
    kw = dict(lanes=4, max_context=16, max_prompt_len=6, max_new_tokens=6,
              requests_per_lane=2, eos_id=0)
    prompts, plens = engine_inputs(EngineConfig(**kw), fam["cfg"].vocab_size, seed=0)
    jeng = JGenerationEngine(fam["jm"], fam["jparams"], JEngineConfig(**kw, backend="pc"))
    want = jeng.generate(prompts, plens)
    eng = GenerationEngine(fam["model"], fam["params"], EngineConfig(**kw))
    got = eng.generate(prompts, plens)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert eng.batched.last_result.steps == jeng.batched.last_result.steps
    assert eng.batched.tag_stats["decode"] == tuple(jeng.batched.tag_stats["decode"])
    oracle = eng.reference_generate(prompts, plens)
    np.testing.assert_array_equal(oracle["tokens"], want["tokens"])

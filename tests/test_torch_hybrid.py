"""The port's ``hybrid`` family (Zamba2: ``repro_torch.models.mamba2`` and
the ``hybrid`` branches of ``models.transformer``) against the JAX package,
with the JAX weights carried across, on the float32 smoke config of
Zamba2-7B (4 mamba layers, the shared attention block after every 2) and
on the same config with a fifth, tail layer after the last site.

Trees, forward logits (plain and K3 attention), loss and every gradient
leaf, 20 decode steps past a 16-slot window (logits, the mamba states and
the shared block's ring cache at each site), the chunked SSD scan from a
carried state, and the serving engine at 4 lanes against the JAX engine.
Tolerances are in tests/torch_parity.py.  The JAX side runs once per
config, in a module-scoped fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as JM  # noqa: E402
from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.engine import GenerationEngine as JGenerationEngine  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.serve.engine import EngineConfig, GenerationEngine  # noqa: E402
from repro_torch.testing import engine_inputs  # noqa: E402
from tests import torch_parity as tp  # noqa: E402

ARCH = "zamba2-7b"
VARIANTS = {"smoke": {}, "tail": dict(num_layers=5)}


def _ssd_inputs(cfg, seed: int):
    """x [B, S, H, P], B and C [B, S, N], dt [B, S, H] > 0, a [H] < 0 and an
    initial state [B, H, P, N]."""
    rng = np.random.default_rng(seed)
    _, h, p, n = M.dims(cfg)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(tp.B, tp.S, h) - 2.0)).astype(np.float32)
    a = -np.arange(1, h + 1, dtype=np.float32) / 4
    return f(tp.B, tp.S, h, p), f(tp.B, tp.S, n), f(tp.B, tp.S, n), dt, a, f(tp.B, h, p, n)


@pytest.fixture(scope="module", params=list(VARIANTS))
def fam(request):
    c = tp.carry(ARCH, **VARIANTS[request.param])
    c["jax"] = tp.jax_results(c)
    c["jax"]["flash"] = np.asarray(tp.j_get_model(c["jcfg"], use_flash=True).forward(
        c["jparams"], {"tokens": jnp.asarray(c["tokens"])})[0])
    return c


def test_init_and_cache_make_the_jax_trees(fam):
    model, cfg = fam["model"], fam["cfg"]
    tp.assert_same_tree(model.init(torch.Generator().manual_seed(0)), fam["jparams"])
    cache = model.init_cache(3, 8)
    tp.assert_same_tree(cache, fam["jax"]["cache3"])
    assert cache["mamba"]["ssm"].shape[:2] == (cfg.num_layers, 3)
    assert cache["shared_kv"]["k"].shape[:2] == (cfg.num_layers // cfg.shared_attn_every, 3)


@pytest.mark.parametrize("use_flash", [False, True], ids=["blocked", "flash"])
def test_forward_matches_jax(fam, use_flash):
    model = get_model(fam["cfg"], use_flash=use_flash, device="cpu")
    logits, aux = model.forward(fam["params"], {"tokens": torch.from_numpy(fam["tokens"])})
    tp.close(logits, fam["jax"]["flash" if use_flash else "logits"])
    assert float(aux["moe_aux_loss"]) == 0.0


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_grads_match_jax(fam, remat):
    (loss, _), grads = tp.port_loss_and_grads(fam, remat)
    np.testing.assert_allclose(float(loss), fam["jax"]["loss"], **tp.LOSS_TOL)
    tp.assert_grads_close(grads, fam["jax"]["grads"])


def test_decode_steps_match_jax_logits_and_cache(fam):
    logits, cache = tp.port_decode(fam)
    tp.close(logits, fam["jax"]["decode"])
    tp.assert_trees_close(cache, fam["jax"]["cache"])


def test_ssd_chunked_from_a_carried_state_matches_jax(fam):
    cfg = fam["cfg"]
    x, b_in, c_in, dt, a, h0 = _ssd_inputs(cfg, 4)
    y, h = M._ssd_chunked(*map(torch.from_numpy, (x, b_in, c_in, dt, a)), cfg.ssm_chunk,
                          h0=torch.from_numpy(h0))
    want_y, want_h = JM._ssd_chunked(*map(jnp.asarray, (x, b_in, c_in, dt, a)), cfg.ssm_chunk,
                                     h0=jnp.asarray(h0))
    tp.close(y, want_y)
    tp.close(h, want_h)


@pytest.mark.parametrize("fam", ["smoke"], indirect=True)
def test_engine_matches_the_jax_engine_at_four_lanes(fam):
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

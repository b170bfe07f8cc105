"""The port's ``ssm`` family (xLSTM: ``repro_torch.models.xlstm`` and the
``ssm`` branches of ``models.transformer``) against the JAX package, with
the JAX weights carried across, on the float32 smoke config of xLSTM-350M
(one mLSTM and one sLSTM a group) and on two variants of it, one with two
groups (``[G]`` of 2) and one with two mLSTMs in its group (``[n_m]`` of
2), so that each nesting level of the tree has more than one entry.

Trees, forward logits, loss and every gradient leaf (finite through the
mLSTM's ``-inf`` masks, ties in its maxima split as ``jax.grad`` splits
them), 20 decode steps past a 16-slot window (logits and every cache
leaf), the chunked mLSTM from a carried state and the sLSTM cell with its
gradient.  The serving engine is held to the JAX package's sequential
oracle (``reference_generate``, which starts each request from
``init_cache``) and to the port's: it resets each lane's cache to
``init_cache`` (stabilizers at -1e30), where the JAX package's engine
zeroes them and so disagrees with its own oracle on this family.
Tolerances are in tests/torch_parity.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import xlstm as JX  # noqa: E402
from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.engine import GenerationEngine as JGenerationEngine  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.serve.engine import EngineConfig, GenerationEngine  # noqa: E402
from repro_torch.testing import engine_inputs  # noqa: E402
from tests import torch_parity as tp  # noqa: E402

ARCH = "xlstm-350m"
VARIANTS = {"smoke": {}, "groups": dict(num_layers=4),
            "pairs": dict(num_layers=3, xlstm_pattern=("mlstm", "mlstm", "slstm"))}


def _state_inputs(cfg, seed: int):
    """mLSTM q, k, v, log gates [B, S, H, P] / [B, S, H] and a carried state."""
    rng = np.random.default_rng(seed)
    h = cfg.num_heads
    p = cfg.ssm_expand * cfg.d_model // h
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    qkv = [f(tp.B, tp.S, h, p) for _ in range(3)]
    log_i = f(tp.B, tp.S, h)
    log_f = -np.log1p(np.exp(-f(tp.B, tp.S, h) - 2.0)).astype(np.float32)
    state = (f(tp.B, h, p, p), f(tp.B, h, p), f(tp.B, h))
    return qkv, log_i, log_f, state


def _cell_inputs(cfg, seed: int):
    rng = np.random.default_rng(seed)
    f = lambda: rng.normal(size=(tp.B, cfg.d_model)).astype(np.float32)  # noqa: E731
    # n at 0 and m at the floor in the first row: the first step's n_new is
    # exactly 1, a tie with the cell's max(n, 1).
    state = [f(), np.abs(f()), f(), f()]
    state[1][0], state[3][0] = 0.0, X.M_FLOOR
    return f(), f(), tuple(state)


@pytest.fixture(scope="module")
def units():
    """The unit functions on the smoke config: both packages' weights, and
    the JAX side's results."""
    c = tp.carry(ARCH)
    cfg = c["jcfg"]
    (q, k, v), li, lf, state = _state_inputs(cfg, 1)
    out, fin = JX._mlstm_chunked(*map(jnp.asarray, (q, k, v, li, lf)), cfg.ssm_chunk,
                                 state=tuple(map(jnp.asarray, state)))
    sp = jax.tree.map(lambda t: t[0], c["jparams"]["groups"]["slstm"]["cell"])
    x_t, xc_t, st = _cell_inputs(cfg, 2)

    def cell_sum(args):
        new, hid = JX._slstm_cell(sp, cfg, args[0], args[1], args[2])
        return jnp.sum(hid) + sum(jnp.sum(s) for s in new[:3]), (new, hid)

    grads, (new, hid) = jax.grad(cell_sum, has_aux=True)(
        (jnp.asarray(x_t), jnp.asarray(xc_t), tuple(map(jnp.asarray, st))))
    return dict(cfg=c["cfg"], params=c["params"],
                mlstm=(np.asarray(out), [np.asarray(s) for s in fin]),
                slstm=([np.asarray(s) for s in new], np.asarray(hid),
                       jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module", params=list(VARIANTS))
def fam(request):
    c = tp.carry(ARCH, **VARIANTS[request.param])
    c["jax"] = tp.jax_results(c)
    return c


def test_init_and_cache_make_the_jax_trees(fam):
    model, cfg = fam["model"], fam["cfg"]
    own = model.init(torch.Generator().manual_seed(0))
    tp.assert_same_tree(own, fam["jparams"])
    cache = model.init_cache(3, 8)
    tp.assert_trees_close(cache, fam["jax"]["cache3"], rtol=0, atol=0)
    n_groups = cfg.num_layers // len(cfg.xlstm_pattern)
    assert cache["mlstm"]["c"].shape[:3] == (n_groups, cfg.xlstm_pattern.count("mlstm"), 3)
    assert cache["slstm"]["m"].shape[:2] == (n_groups, 3)


def test_forward_matches_jax(fam):
    logits, aux = fam["model"].forward(fam["params"], {"tokens": torch.from_numpy(fam["tokens"])})
    tp.close(logits, fam["jax"]["logits"])
    assert float(aux["moe_aux_loss"]) == float(fam["jax"]["aux"]["moe_aux_loss"]) == 0.0


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax(fam, remat):
    (loss, _), grads = tp.port_loss_and_grads(fam, remat)
    np.testing.assert_allclose(float(loss), fam["jax"]["loss"], **tp.LOSS_TOL)
    tp.assert_grads_close(grads, fam["jax"]["grads"])


def test_decode_steps_match_jax_logits_and_cache(fam):
    logits, cache = tp.port_decode(fam)
    tp.close(logits, fam["jax"]["decode"])
    tp.assert_trees_close(cache, fam["jax"]["cache"])


def test_mlstm_chunked_from_a_carried_state_matches_jax(units):
    cfg = units["cfg"]
    (q, k, v), li, lf, state = _state_inputs(cfg, 1)
    out, fin = X._mlstm_chunked(*map(torch.from_numpy, (q, k, v, li, lf)), cfg.ssm_chunk,
                                state=tuple(map(torch.from_numpy, state)))
    want_out, want_fin = units["mlstm"]
    tp.close(out, want_out)
    for got, want in zip(fin, want_fin, strict=True):
        tp.close(got, want)


def test_slstm_cell_and_its_gradient_match_jax(units):
    cfg = units["cfg"]
    sp = {k: v[0] for k, v in units["params"]["groups"]["slstm"]["cell"].items()}
    x_t, xc_t, st = _cell_inputs(cfg, 2)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x_t, xc_t, *st)]
    new, hid = X._slstm_cell(sp, cfg, args[0], args[1], tuple(args[2:]))
    grads = torch.autograd.grad(hid.sum() + sum(s.sum() for s in new[:3]), args)
    want_new, want_hid, want_grads = units["slstm"]
    tp.close(hid, want_hid)
    for got, want in zip(new, want_new, strict=True):
        tp.close(got, want)
    want_flat = [want_grads[0], want_grads[1], *want_grads[2]]
    for got, want in zip(grads, want_flat, strict=True):
        tp.close(got, want)


@pytest.mark.parametrize("fam", ["smoke"], indirect=True)
def test_engine_matches_the_oracle(fam):
    kw = dict(lanes=4, max_context=16, max_prompt_len=6, max_new_tokens=6,
              requests_per_lane=2, eos_id=0)
    prompts, plens = engine_inputs(EngineConfig(**kw), fam["cfg"].vocab_size, seed=0)
    eng = GenerationEngine(fam["model"], fam["params"], EngineConfig(**kw))
    got = eng.generate(prompts, plens)
    jeng = JGenerationEngine(fam["jm"], fam["jparams"], JEngineConfig(**kw, backend="pc"))
    for want in (jeng.reference_generate(prompts, plens), eng.reference_generate(prompts, plens)):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert got["lengths"].sum() > 0
    # each request starts from init_cache: the stabilizers at the floor
    assert sum(bool((x == X.M_FLOOR).all()) for x in eng.member_inits) == 2


@pytest.mark.parametrize("fam", ["smoke"], indirect=True)
def test_engine_refuses_a_decode_cache_of_another_tree(fam):
    """The engine hands the cache leaves over in ``init_cache``'s flatten
    order; a decode step whose new cache flattens in another order (here
    its groups' keys reversed) raises instead of mixing leaves up: at
    type inference, which runs the step on fake tensors."""
    model = get_model(fam["cfg"], device="cpu")
    step = model.decode_step

    def reordered(params, cache, tokens, pos):
        logits, new = step(params, cache, tokens, pos)
        return logits, dict(reversed(list(new.items())))

    model.decode_step = reordered
    kw = dict(lanes=2, max_context=8, max_prompt_len=2, max_new_tokens=2,
              requests_per_lane=1, eos_id=0)
    prompts, plens = engine_inputs(EngineConfig(**kw), fam["cfg"].vocab_size, seed=0)
    with pytest.raises(TypeError, match="cache of another tree than init_cache's"):
        GenerationEngine(model, fam["params"], EngineConfig(**kw)).generate(prompts, plens)

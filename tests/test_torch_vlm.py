"""The port's ``vlm`` family (Qwen2-VL: M-RoPE in ``repro_torch.models.layers``
and the ``vlm`` branches of ``models.transformer``) against the JAX package
on the float32 smoke config of Qwen2-VL-2B (sections (2, 3, 3) of a 16-wide
head), with the JAX weights carried across.

The batch holds 4 patch embeddings and 28 text tokens with 3-axis
positions as Qwen2-VL lays them out: the patches at t = 0 on a 2 x 2 (h,
w) grid, the text after them, equal on the three axes.  Trees, forward
logits (plain and K3 attention), loss and every gradient leaf, 20 decode
steps past a 16-slot window (logits and cache), ``rope_angles`` at random
distinct per-axis positions, attention under a ``seg_mask`` with padded
keys and an all-padded row, ``make_batch`` and ``SyntheticStream`` against
the reference's draws, and the serving engine at 4 lanes against the JAX
package's oracle.  Tolerances are in tests/torch_parity.py.  The JAX side
runs once, in a module-scoped fixture.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.engine import GenerationEngine as JGenerationEngine  # noqa: E402
from repro.train import data as j_data  # noqa: E402
from repro_torch.mcmc import prng  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serve.engine import EngineConfig, GenerationEngine  # noqa: E402
from repro_torch.testing import engine_inputs  # noqa: E402
from repro_torch.train import data as data_lib  # noqa: E402
from tests import torch_parity as tp  # noqa: E402

ARCH = "qwen2-vl-2b"
GRID = 2  # patches on a GRID x GRID (h, w) grid


def vlm_batch(cfg) -> dict:
    """``GRID**2`` patch embeddings, then text tokens; positions [B, 3, S]:
    (0, i // GRID, i % GRID) for patch i, then ``GRID + j`` on every axis
    for text token j."""
    rng = np.random.default_rng(0)
    si = GRID * GRID
    st = tp.S - si
    grid = np.stack([np.zeros(si), np.arange(si) // GRID, np.arange(si) % GRID])
    text = np.broadcast_to(GRID + np.arange(st), (3, st))
    positions = np.broadcast_to(np.concatenate([grid, text], axis=1), (tp.B, 3, tp.S))
    return {"tokens": rng.integers(0, cfg.vocab_size, (tp.B, st)).astype(np.int32),
            "patch_embeds": rng.normal(size=(tp.B, si, cfg.d_model)).astype(np.float32),
            "positions": np.ascontiguousarray(positions, np.int32)}


@pytest.fixture(scope="module")
def fam():
    c = tp.carry(ARCH, batch=vlm_batch)
    c["jax"] = tp.jax_results(c)
    c["jax"]["flash"] = np.asarray(tp.j_get_model(c["jcfg"], use_flash=True).forward(
        c["jparams"], tp.jax_batch(c))[0])
    return c


def test_init_and_cache_make_the_jax_trees(fam):
    model = fam["model"]
    tp.assert_same_tree(model.init(torch.Generator().manual_seed(0)), fam["jparams"])
    tp.assert_same_tree(model.init_cache(3, 8), fam["jax"]["cache3"])
    assert model.attention_sites == fam["cfg"].num_layers


@pytest.mark.parametrize("use_flash", [False, True], ids=["blocked", "flash"])
def test_forward_matches_jax(fam, use_flash):
    model = get_model(fam["cfg"], use_flash=use_flash, device="cpu")
    logits, aux = model.forward(fam["params"], tp.port_batch(fam))
    assert logits.shape == (tp.B, tp.S, fam["cfg"].vocab_size)
    tp.close(logits, fam["jax"]["flash" if use_flash else "logits"])
    assert float(aux["moe_aux_loss"]) == 0.0


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_grads_match_jax(fam, remat):
    (loss, _), grads = tp.port_loss_and_grads(fam, remat)
    np.testing.assert_allclose(float(loss), fam["jax"]["loss"], **tp.LOSS_TOL)
    tp.assert_grads_close(grads, fam["jax"]["grads"])


def test_loss_is_next_token_over_the_text_alone(fam):
    """The patches are neither predicted nor targets: the loss is the mean
    next-token cross-entropy over the text positions but the last."""
    logits = torch.tensor(fam["jax"]["logits"], dtype=torch.float64)
    si = GRID * GRID
    tokens = torch.from_numpy(fam["batch"]["tokens"]).long()
    pred = logits[:, si:-1]  # text position j predicts text token j + 1
    nll = torch.logsumexp(pred, -1) - pred.gather(-1, tokens[:, 1:, None])[..., 0]
    loss, _ = fam["model"].loss(fam["params"], tp.port_batch(fam))
    np.testing.assert_allclose(float(loss), float(nll.mean()), **tp.LOSS_TOL)


def test_decode_steps_match_jax_logits_and_cache(fam):
    logits, cache = tp.port_decode(fam)
    tp.close(logits, fam["jax"]["decode"])
    tp.assert_trees_close(cache, fam["jax"]["cache"])


@pytest.mark.parametrize("sections,head_dim", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_rope_angles_match_jax_at_distinct_axes(sections, head_dim):
    """Random, different positions on the three axes: a wrong section split
    would pass with one position broadcast to all three."""
    pos = np.random.default_rng(1).integers(0, 4096, (2, 3, 24)).astype(np.int32)
    got = L.rope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    want = JL.rope_angles(jnp.asarray(pos), head_dim, 1e6, sections)
    for g, w in zip(got, want):
        assert g.shape == (2, 24, head_dim // 2)
        tp.close(g, w)
    plain = L.rope_angles(torch.from_numpy(pos[:, 0]), head_dim, 1e6)[0]
    assert not torch.allclose(got[0], plain)


def _seg_mask() -> np.ndarray:
    """Row 0 pads its last 5 keys, row 1 pads every key."""
    mask = np.ones((tp.B, tp.S), bool)
    mask[0, -5:] = False
    mask[1] = False
    return mask


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize("use_flash", [False, True], ids=["blocked", "flash"])
def test_attention_with_seg_mask_matches_jax(fam, causal, use_flash):
    """A ``seg_mask`` keeps the plain path even with ``use_flash`` (the
    reference's rule); the all-padded row gets the uniform softmax."""
    cfg = dataclasses.replace(fam["cfg"], causal=causal)
    jcfg = dataclasses.replace(fam["jcfg"], causal=causal)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(tp.B, tp.S, cfg.d_model)).astype(np.float32)
    mask = _seg_mask()
    lp = {k: v[0] for k, v in fam["params"]["layers"]["attn"].items()}
    jlp = {k: v[0] for k, v in fam["jparams"]["layers"]["attn"].items()}
    pos = fam["batch"]["positions"]
    got = L.attention(lp, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                      seg_mask=torch.from_numpy(mask), use_flash=use_flash)
    want = JL.attention(jlp, jnp.asarray(x), jcfg, jnp.asarray(pos), seg_mask=jnp.asarray(mask))
    tp.close(got, want)
    free = JL.attention(jlp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    assert not np.allclose(np.asarray(want), np.asarray(free), atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_batch_draws_the_reference_inputs(dtype):
    cfg, jcfg, shape, jshape = tp.smoke_shapes(ARCH, dtype)
    got = get_model(cfg, device="cpu").make_batch(prng.prng_key(5), shape)
    want = tp.j_get_model(jcfg).make_batch(jax.random.PRNGKey(5), jshape)
    assert got["patch_embeds"].dtype == L.cdtype(cfg)
    assert got["positions"].shape == (3, 3, 32) and got["tokens"].shape == (3, 28)
    tp.assert_draws_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_stream_draws_the_reference_batches(dtype):
    cfg, jcfg, shape, jshape = tp.smoke_shapes(ARCH, dtype)
    stream = data_lib.SyntheticStream(get_model(cfg, device="cpu"), shape)
    jstream = j_data.SyntheticStream(tp.j_get_model(jcfg), jshape)
    for step in (0, 7):
        tp.assert_draws_equal(stream.batch(step), jstream.batch(step))


def test_engine_matches_the_jax_oracle_at_four_lanes(fam):
    """Text prompts through the decode step, as the JAX engine serves them."""
    kw = dict(lanes=4, max_context=16, max_prompt_len=6, max_new_tokens=6,
              requests_per_lane=2, eos_id=0)
    prompts, plens = engine_inputs(EngineConfig(**kw), fam["cfg"].vocab_size, seed=0)
    jeng = JGenerationEngine(fam["jm"], fam["jparams"], JEngineConfig(**kw, backend="pc"))
    want = jeng.reference_generate(prompts, plens)
    eng = GenerationEngine(fam["model"], fam["params"], EngineConfig(**kw))
    got = eng.generate(prompts, plens)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    np.testing.assert_array_equal(eng.reference_generate(prompts, plens)["tokens"],
                                  want["tokens"])

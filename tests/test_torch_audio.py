"""The port's ``audio`` family (HuBERT: the ``audio`` branches of
``repro_torch.models.transformer``, a non-causal encoder with ``ln`` norms
and GELU MLPs) against the JAX package on the float32 smoke config of
HuBERT-XLarge, with the JAX weights carried across.

Trees, forward logits (``use_flash`` leaves a non-causal layer on the plain
attention, as in the reference), the per-frame loss and every gradient
leaf, ``make_batch`` and ``SyntheticStream`` against the reference's
draws, one train step through the launcher, and the refusals of the
decode path and of the serving engine.  Tolerances are in
tests/torch_parity.py.  The JAX side runs once, in a module-scoped fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.engine import GenerationEngine as JGenerationEngine  # noqa: E402
from repro.train import data as j_data  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.mcmc import prng  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve.engine import EngineConfig, GenerationEngine  # noqa: E402
from repro_torch.train import data as data_lib  # noqa: E402
from tests import torch_parity as tp  # noqa: E402

ARCH = "hubert-xlarge"


def audio_batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    return {"frames": rng.normal(size=(tp.B, tp.S, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (tp.B, tp.S)).astype(np.int32)}


@pytest.fixture(scope="module")
def fam():
    c = tp.carry(ARCH, batch=audio_batch)
    c["jax"] = tp.jax_results(c)
    return c


def test_init_makes_the_jax_tree(fam):
    own = fam["model"].init(torch.Generator().manual_seed(0))
    tp.assert_same_tree(own, fam["jparams"])
    assert "embed" not in own and own["lm_head"].shape == (fam["cfg"].d_model,
                                                           fam["cfg"].vocab_size)
    assert fam["model"].attention_sites == 0


@pytest.mark.parametrize("use_flash", [False, True], ids=["blocked", "flash"])
def test_forward_matches_jax(fam, use_flash, monkeypatch):
    def no_k3(*args, **kwargs):
        raise AssertionError("a non-causal layer reached K3")

    monkeypatch.setattr(flash_ops, "flash_attention", no_k3)
    model = get_model(fam["cfg"], use_flash=use_flash, device="cpu")
    logits, aux = model.forward(fam["params"], tp.port_batch(fam))
    assert logits.shape == (tp.B, tp.S, fam["cfg"].vocab_size)
    tp.close(logits, fam["jax"]["logits"])
    assert float(aux["moe_aux_loss"]) == 0.0


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_grads_match_jax(fam, remat):
    (loss, _), grads = tp.port_loss_and_grads(fam, remat)
    np.testing.assert_allclose(float(loss), fam["jax"]["loss"], **tp.LOSS_TOL)
    tp.assert_grads_close(grads, fam["jax"]["grads"])


def test_loss_classifies_every_frame_unshifted(fam):
    logits = torch.tensor(fam["jax"]["logits"], dtype=torch.float64)
    labels = torch.from_numpy(fam["batch"]["labels"]).long()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]
    loss, _ = fam["model"].loss(fam["params"], tp.port_batch(fam))
    np.testing.assert_allclose(float(loss), float(nll.mean()), **tp.LOSS_TOL)


def test_decode_and_the_engine_are_refused_as_in_the_reference(fam):
    model = fam["model"]
    kw = dict(lanes=2, max_context=8, max_prompt_len=4, max_new_tokens=4,
              requests_per_lane=1, eos_id=0)
    with pytest.raises(ValueError, match="audio has no decode path") as want:
        JGenerationEngine(fam["jm"], fam["jparams"], JEngineConfig(**kw))
    with pytest.raises(ValueError, match=str(want.value)):
        GenerationEngine(model, fam["params"], EngineConfig(**kw))
    with pytest.raises(ValueError, match="audio has no decode path"):
        model.init_cache(2, 8)
    with pytest.raises(ValueError, match="audio has no decode path"):
        model.decode_step(fam["params"], {}, torch.zeros(2, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_batch_draws_the_reference_inputs(dtype):
    cfg, jcfg, shape, jshape = tp.smoke_shapes(ARCH, dtype)
    got = get_model(cfg, device="cpu").make_batch(prng.prng_key(6), shape)
    want = tp.j_get_model(jcfg).make_batch(jax.random.PRNGKey(6), jshape)
    assert got["frames"].shape == (3, 32, cfg.d_model) and got["labels"].shape == (3, 32)
    tp.assert_draws_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_stream_draws_the_reference_batches(dtype):
    cfg, jcfg, shape, jshape = tp.smoke_shapes(ARCH, dtype)
    stream = data_lib.SyntheticStream(get_model(cfg, device="cpu"), shape)
    jstream = j_data.SyntheticStream(tp.j_get_model(jcfg), jshape)
    for step in (0, 3):
        tp.assert_draws_equal(stream.batch(step), jstream.batch(step))


def test_the_launcher_trains_the_encoder():
    model, params, opt_state, step, stream = launch.build_trainer(
        ARCH, seq_len=16, global_batch=2, steps=2, lr=1e-3, microbatches=1, remat="none",
        smoke=True, device="cpu")
    losses = []
    for i in range(2):
        params, opt_state, metrics = step(params, opt_state, stream.batch(i))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses

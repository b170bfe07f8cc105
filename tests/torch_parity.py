"""Helpers shared by the model-family parity tests (tests/test_torch_moe.py,
test_torch_ssm.py, test_torch_hybrid.py): the JAX weights carried into the
port, trees compared leaf by leaf under JAX's key paths, and the JAX
side's jitted forward, loss gradient and decode steps.

Tolerances (float32 smoke configs, O(1) activations and logits, sums taken
in another order by the two libraries): values within ``TOL``; the loss
within ``LOSS_TOL``; each gradient leaf within 1e-5 of the largest
magnitude of the reference leaf, as tests/test_torch_train.py holds the
dense family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.utils._pytree as pytree

from repro import configs as j_configs
from repro.models import get_model as j_get_model
from repro_torch import configs, interop
from repro_torch.models import get_model
from repro_torch.train import train_step as ts

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5)
B, S, W, DECODE_STEPS = 2, 32, 16, 20


def np_(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, **tol) -> None:
    np.testing.assert_allclose(np_(got), np_(want), **(tol or TOL))


def leaves(tree) -> dict:
    """``{key path: numpy leaf}`` of a JAX or a port tree; both packages
    print a path the same way (``['layers']['attn']['wq']``, ``[0]`` for a
    list entry)."""
    if any(isinstance(x, torch.Tensor) for x in pytree.tree_leaves(tree)):
        return {pytree.keystr(p): np_(x) for p, x in pytree.tree_flatten_with_path(tree)[0]}
    return {jax.tree_util.keystr(p): np_(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_same_tree(got, want) -> None:
    """The same key paths, shapes and dtypes."""
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys(), (sorted(g.keys() ^ w.keys()))
    for k in w:
        assert (g[k].shape, g[k].dtype) == (w[k].shape, w[k].dtype), k


def assert_trees_close(got, want, **tol) -> None:
    assert_same_tree(got, want)
    g, w = leaves(got), leaves(want)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **(tol or TOL))


def assert_grads_close(got, want) -> None:
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert np.isfinite(g[k]).all(), k
        np.testing.assert_allclose(g[k], w[k], rtol=0, err_msg=k,
                                   atol=1e-5 * max(np.abs(w[k]).max(), 1e-30))


def carry(name: str, **overrides):
    """The JAX model and weights of ``name``'s smoke config (fields
    replaced by ``overrides`` in both packages), the port's model on the
    CPU and the same weights, and seeded tokens ``[B, S]``."""
    jcfg = dataclasses.replace(j_configs.get_smoke_config(name), **overrides)
    cfg = dataclasses.replace(configs.get_smoke_config(name), **overrides)
    jm = j_get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, jparams=jparams, model=get_model(cfg, device="cpu"),
                params=params, tokens=tokens)


def decode_positions(step: int) -> np.ndarray:
    """The second sequence lags, so the two fill the ring differently and
    the first wraps past ``W``."""
    return np.array([step, max(step - 5, 0)], np.int32)


def jax_results(c: dict) -> dict:
    """The JAX side of the family tests: forward (logits, aux), loss and
    gradient, ``DECODE_STEPS`` decode steps against a ``W``-slot cache
    (logits of every step, the final cache), and init_cache at batch 3."""
    jm, p, tokens = c["jm"], c["jparams"], jnp.asarray(c["tokens"])
    logits, aux = jax.jit(jm.forward)(p, {"tokens": tokens})
    (loss, laux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(p, {"tokens": tokens})
    step = jax.jit(jm.decode_step)
    cache, steps = jm.init_cache(B, W), []
    for i in range(DECODE_STEPS):
        lg, cache = step(p, cache, tokens[:, i], jnp.asarray(decode_positions(i)))
        steps.append(np.asarray(lg))
    return dict(logits=np.asarray(logits), aux=jax.tree.map(np.asarray, aux),
                loss=float(loss), laux=jax.tree.map(np.asarray, laux),
                grads=jax.tree.map(np.asarray, grads), decode=np.stack(steps),
                cache=jax.tree.map(np.asarray, cache),
                cache3=jax.tree.map(np.asarray, jm.init_cache(3, 8)))


def port_loss_and_grads(c: dict, remat: str = "none"):
    return ts._value_and_grad(lambda p, b: c["model"].loss(p, b, remat=remat), c["params"],
                              {"tokens": torch.from_numpy(c["tokens"])})


def port_decode(c: dict):
    """The port's side of :func:`jax_results`' decode: (logits of every
    step, the final cache); the cache passed in is never written."""
    model, tokens = c["model"], c["tokens"]
    cache, steps = model.init_cache(B, W), []
    for i in range(DECODE_STEPS):
        first = cache
        snapshot = {k: v.copy() for k, v in leaves(first).items()}
        lg, cache = model.decode_step(c["params"], cache, torch.from_numpy(tokens[:, i]),
                                      torch.from_numpy(decode_positions(i)))
        assert lg.dtype == torch.float32 and cache is not first
        assert all(np.array_equal(v, snapshot[k]) for k, v in leaves(first).items())
        steps.append(lg)
    return torch.stack(steps), cache

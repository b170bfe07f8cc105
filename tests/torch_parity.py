"""Helpers shared by the model-family parity tests (tests/test_torch_moe.py,
test_torch_ssm.py, test_torch_hybrid.py, test_torch_vlm.py,
test_torch_audio.py, test_torch_kv_int8.py): the JAX weights carried into
the port, trees compared leaf by leaf under JAX's key paths, and the JAX
side's jitted forward, loss gradient and decode steps on a batch dict.

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
    """A tensor or JAX array as numpy; bf16 as JAX's numpy bf16."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if x.dtype == torch.bfloat16:
        return x.detach().cpu().float().numpy().astype(jnp.bfloat16)
    return x.detach().cpu().numpy()


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
        got_k, want_k = (g[k], w[k]) if w[k].dtype != jnp.bfloat16 else (
            g[k].astype(np.float32), w[k].astype(np.float32))
        np.testing.assert_allclose(got_k, want_k, err_msg=k, **(tol or TOL))


def assert_grads_close(got, want) -> None:
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert np.isfinite(g[k]).all(), k
        np.testing.assert_allclose(g[k], w[k], rtol=0, err_msg=k,
                                   atol=1e-5 * max(np.abs(w[k]).max(), 1e-30))


def carry(name: str, batch=None, **overrides):
    """The JAX model and weights of ``name``'s smoke config (fields
    replaced by ``overrides`` in both packages), the port's model on the
    CPU and the same weights, and a numpy batch: ``batch(cfg)`` if given,
    else seeded tokens ``[B, S]``.  ``tokens`` is the batch's tokens (the
    decode steps' inputs), when it has any."""
    jcfg = dataclasses.replace(j_configs.get_smoke_config(name), **overrides)
    cfg = dataclasses.replace(configs.get_smoke_config(name), **overrides)
    jm = j_get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    if batch is None:
        data = {"tokens": np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)}
    else:
        data = batch(cfg)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, jparams=jparams, model=get_model(cfg, device="cpu"),
                params=params, batch=data, tokens=data.get("tokens"))


def jax_batch(c: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in c["batch"].items()}


def port_batch(c: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in c["batch"].items()}


def decode_positions(step: int) -> np.ndarray:
    """The second sequence lags, so the two fill the ring differently and
    the first wraps past ``W``."""
    return np.array([step, max(step - 5, 0)], np.int32)


def jax_results(c: dict) -> dict:
    """The JAX side of the family tests: forward (logits, aux), loss and
    gradient, and for a model that decodes ``DECODE_STEPS`` decode steps
    against a ``W``-slot cache (logits of every step, the final cache) and
    init_cache at batch 3."""
    jm, p, batch = c["jm"], c["jparams"], jax_batch(c)
    logits, aux = jax.jit(jm.forward)(p, batch)
    (loss, laux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(p, batch)
    out = dict(logits=np.asarray(logits), aux=jax.tree.map(np.asarray, aux),
               loss=float(loss), laux=jax.tree.map(np.asarray, laux),
               grads=jax.tree.map(np.asarray, grads))
    if c["jcfg"].supports_decode:
        out.update(jax_decode(c))
        out["cache3"] = jax.tree.map(np.asarray, jm.init_cache(3, 8))
    return out


def jax_decode(c: dict, jm=None) -> dict:
    """``DECODE_STEPS`` JAX decode steps of ``jm`` (default: ``c``'s model)
    on ``c``'s tokens: the logits of every step and the final cache."""
    jm = jm or c["jm"]
    tokens = jnp.asarray(c["tokens"])
    step = jax.jit(jm.decode_step)
    cache, steps = jm.init_cache(B, W), []
    for i in range(DECODE_STEPS):
        lg, cache = step(c["jparams"], cache, tokens[:, i], jnp.asarray(decode_positions(i)))
        steps.append(np.asarray(lg))
    return dict(decode=np.stack(steps), cache=jax.tree.map(np.asarray, cache))


def port_loss_and_grads(c: dict, remat: str = "none"):
    return ts._value_and_grad(lambda p, b: c["model"].loss(p, b, remat=remat), c["params"],
                              port_batch(c))


def port_decode(c: dict, model=None):
    """The port's side of :func:`jax_decode`: (logits of every step, the
    final cache) of ``model`` (default: ``c``'s); the cache passed in is
    never written."""
    model, tokens = model or c["model"], c["tokens"]
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


def smoke_shapes(name: str, dtype: str):
    """``name``'s smoke config in ``dtype`` and a 3 x 32 train shape, in
    each package: (cfg, JAX cfg, shape, JAX shape)."""
    cfg = dataclasses.replace(configs.get_smoke_config(name), compute_dtype=dtype)
    jcfg = dataclasses.replace(j_configs.get_smoke_config(name), compute_dtype=dtype)
    shape = configs.ShapeSpec("t", 32, 3, "train")
    jshape = j_configs.ShapeSpec("t", 32, 3, "train")
    return cfg, jcfg, shape, jshape


def assert_draws_equal(got: dict, want: dict) -> None:
    """Integer inputs and bf16 floats bit for bit; float32 normals within
    a few ulp, as tests/test_torch_prng.py holds ``prng.normal`` (its
    float32 ``log1p`` is not XLA's)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16 else w)
        assert g.shape == w.shape, k
        if g.dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, rtol=3e-7, atol=1e-8, err_msg=k)
        else:
            np.testing.assert_array_equal(np_(g.float() if g.is_floating_point() else g), w,
                                          err_msg=k)

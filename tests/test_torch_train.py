"""The port's training substrate (``repro_torch.train``, ``launch.train``,
the model's loss and remat) against the JAX package's, on the float32
SmolLM-135M smoke config and ``ShapeSpec("t", 32, 4, "train")`` as in
tests/test_train.py, with the JAX weights and optimizer state carried
across by ``interop``.

Tolerances, each chosen before the run from the dtype and the size of the
values:
* integers are bit-exact: threefry ``fold_in`` and ``randint``, every token
  of the data stream;
* loss and gradients (float32, O(1) loss, sums taken in another order by
  two libraries): loss ``rtol=1e-5``; each gradient leaf within ``1e-5`` of
  its largest magnitude;
* ``apply_updates`` on identical gradients: ``rtol=1e-5, atol=1e-7``
  (elementwise float32 arithmetic; ``sqrt`` and ``pow`` may differ by an
  ulp between the libraries);
* the schedule: ``rtol=1e-6``;
* the port against itself where only the order of float32 sums changes
  (microbatches): the reference's own ``rtol=1e-5`` (loss) and
  ``rtol=2e-3, atol=2e-5`` (params);
* replay after a failure, checkpoints and serving tokens: bit-exact.

Losses and gradients are compared step by step on the same state, not
params after several steps: Adam's ``mhat / (sqrt(vhat) + eps)`` is close
to +-1 for a gradient near zero, so one ulp of gradient can move a
parameter by up to 2 x lr between two libraries.  The JAX side's jitted
steps are made once, in module-scoped fixtures.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import data as j_data  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.mcmc import prng  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train import data as data_lib  # noqa: E402
from repro_torch.train import fault_tolerance as ft  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "smollm-135m"
SHAPE = ShapeSpec("t", 32, 4, "train")
J_SHAPE = JShapeSpec("t", 32, 4, "train")
LOSS_TOL = dict(rtol=1e-5)
UPDATE_TOL = dict(rtol=1e-5, atol=1e-7)
OCFG = dict(peak_lr=1e-3, warmup_steps=0, total_steps=100)


def _leaves(tree) -> list:
    """Leaves as numpy, in JAX's flatten order, from either package."""
    return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in tree_flatten(tree)[0]]


def _grads_close(got, want) -> None:
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    """Both packages' model, the same weights, and both data streams."""
    jcfg, cfg = j_configs.get_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    jm = j_get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = get_model(cfg, device="cpu")
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return {"jm": jm, "jparams": jparams, "jstream": j_data.SyntheticStream(jm, J_SHAPE),
            "cfg": cfg, "model": model, "params": params,
            "stream": data_lib.SyntheticStream(model, SHAPE)}


@pytest.fixture(scope="module")
def jax_fns(setup):
    """The JAX side's jitted functions, made once and shared by the tests."""
    jm = setup["jm"]
    made = {}

    def get(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in made:
            if name == "value_and_grad":
                made[key] = jax.jit(jax.value_and_grad(
                    lambda p, b: jm.loss(p, b, remat=kw["remat"]), has_aux=True))
            else:  # a train step
                tcfg = j_ts.TrainConfig(microbatches=kw.get("microbatches", 1),
                                        opt=j_opt.OptimizerConfig(**OCFG))
                made[key] = jax.jit(j_ts.make_train_step(jm, tcfg))
        return made[key]

    return get


def _opt_state_to_port(jstate, cfg):
    return interop.opt_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")


# ---------------------------------------------------------------------------
# Threefry: fold_in and randint
# ---------------------------------------------------------------------------


def test_fold_in_is_bit_exact_over_keys_and_data():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint64).astype(np.uint32)
    data = [0, 1, 5, 2**31 - 1, 2**31, 2**32 - 1] + [int(x) for x in rng.integers(0, 2**32, 58)]
    want = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k), d)) for k, d in zip(raw, data)])
    got = np.stack([interop.keys_to_numpy(prng.fold_in(interop.keys_from_numpy(k, "cpu"), d))
                    for k, d in zip(raw, data)])
    np.testing.assert_array_equal(got, want)
    assert interop.keys_to_numpy(prng.fold_in(prng.prng_key(0), 5)).tolist() == [
        1524306142, 1887795613]


@pytest.mark.parametrize("lo,hi", [
    (0, 4), (0, 256), (0, 49_152), (0, 151_936), (-7, 9), (0, 65_537), (3, 2**20 + 7),
    (0, 2**31 - 1), (-2**31, 2**31 - 1), (2**31 - 5, 2**31 - 1), (5, 5), (9, 2),
])
def test_randint_is_bit_exact(lo, hi):
    rng = np.random.default_rng(hi % 1000)
    for raw in rng.integers(0, 2**32, size=(8, 2), dtype=np.uint64).astype(np.uint32):
        want = np.asarray(jax.random.randint(jnp.asarray(raw), (3, 50), lo, hi, jnp.int32))
        got = prng.randint(interop.keys_from_numpy(raw, "cpu"), (3, 50), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_matches_the_documented_draws():
    assert prng.randint(prng.prng_key(0), (3,), 0, 49_152).tolist() == [33637, 24912, 40904]
    with pytest.raises(OverflowError):
        prng.randint(prng.prng_key(0), (3,), 0, 2**31)


# ---------------------------------------------------------------------------
# The data stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-0.6b"])
def test_stream_is_bit_exact_at_the_full_vocabulary(arch):
    """At Qwen3-0.6B's vocabulary (151,936) ``t * mult`` passes 2**31 and
    wraps in int32; at SmolLM's (49,152) it does not."""
    jm = j_get_model(j_configs.get_config(arch))
    cfg = configs.get_config(arch)
    js = j_data.SyntheticStream(jm, J_SHAPE)
    ts_ = data_lib.SyntheticStream(get_model(cfg, device="cpu"), SHAPE)
    for step in (0, 1, 7, 123, 10_000):
        want = np.asarray(js.batch(step)["tokens"])
        got = ts_.batch(step)["tokens"]
        assert got.dtype == torch.int32 and got.shape == (4, 32)
        np.testing.assert_array_equal(got.numpy(), want)
    wraps = int(want.max()) * ts_.cfg.mult >= 2**31
    assert wraps == (arch == "qwen3-0.6b")


def test_stream_is_deterministic_and_resumable(setup):
    s1 = data_lib.SyntheticStream(setup["model"], SHAPE)
    s2 = data_lib.SyntheticStream(setup["model"], SHAPE)
    b1 = s1.batch(7)
    s2.batch(3)  # another call history
    assert torch.equal(b1["tokens"], s2.batch(7)["tokens"])


def test_markov_structure_is_learnable(setup):
    stream = setup["stream"]
    toks = stream.batch(0)["tokens"].numpy().astype(np.int64)
    v = setup["cfg"].vocab_size
    pred = (toks[:, :-1] * stream.cfg.mult + 17) % v
    assert ((toks[:, 1:] - pred) % v).max() < stream.cfg.noise_levels


def test_decode_specs_and_make_batch_match_jax(setup):
    jm, model = setup["jm"], setup["model"]
    for kind in ("train", "decode"):
        jspecs = jm.input_specs(JShapeSpec("s", 16, 3, kind))
        specs = model.input_specs(ShapeSpec("s", 16, 3, kind))
        assert {k: tuple(v.shape) for k, v in specs.items()} == {
            k: tuple(v.shape) for k, v in jspecs.items()}
        jb = jm.make_batch(jax.random.PRNGKey(4), JShapeSpec("s", 16, 3, kind))
        tb = model.make_batch(prng.prng_key(4), ShapeSpec("s", 16, 3, kind))
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


# ---------------------------------------------------------------------------
# The model's loss, remat and compute copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_jax(setup, jax_fns, remat):
    jb = setup["jstream"].batch(0)
    (jl, jaux), jg = jax_fns("value_and_grad", remat=remat)(setup["jparams"], jb)
    loss_fn = lambda p, b: setup["model"].loss(p, b, remat=remat)  # noqa: E731
    (tl, taux), tg = ts._value_and_grad(loss_fn, setup["params"], setup["stream"].batch(0))
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]), **LOSS_TOL)
    assert float(taux["moe_aux_loss"]) == float(jaux["moe_aux_loss"]) == 0.0
    _grads_close(tg, jg)


def test_remat_dots_saves_weight_products_and_recomputes_batched_ones(setup, monkeypatch):
    seen = []

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        seen.append((op, decision))
        return decision

    policy = transformer._dots_policy
    monkeypatch.setattr(transformer, "_dots_policy", spy)
    loss_fn = lambda p, b: setup["model"].loss(p, b, remat="dots")  # noqa: E731
    ts._value_and_grad(loss_fn, setup["params"], setup["stream"].batch(0))
    saved = {op for op, d in seen if d == transformer.CheckpointPolicy.MUST_SAVE}
    recomputed = {op for op, d in seen if d == transformer.CheckpointPolicy.PREFER_RECOMPUTE}
    assert torch.ops.aten.mm.default in saved
    assert torch.ops.aten.bmm.default in recomputed


def test_remat_rejects_an_unknown_mode(setup):
    with pytest.raises(ValueError, match="remat"):
        setup["model"].loss(setup["params"], setup["stream"].batch(0), remat="some")


def test_loss_mask_matches_jax(setup):
    mask = np.ones((4, 32), np.float32)
    mask[:, 20:] = 0.0
    mask[1, 3] = 0.0
    jb = dict(setup["jstream"].batch(2), loss_mask=jnp.asarray(mask))
    tb = dict(setup["stream"].batch(2), loss_mask=torch.from_numpy(mask))
    want, _ = setup["jm"].loss(setup["jparams"], jb)
    got, _ = setup["model"].loss(setup["params"], tb)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-0.6b"])
def test_cast_for_compute_casts_the_reference_leaves(arch):
    jcfg = dataclasses.replace(j_configs.get_smoke_config(arch), compute_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype="bfloat16")
    jm = j_get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    want = [str(x.dtype) for x in jax.tree.leaves(jm.cast_for_compute(jparams))]
    cast = get_model(cfg, device="cpu").cast_for_compute(params)
    got = [str(x.dtype).replace("torch.", "") for x in tree_flatten(cast)[0]]
    assert got == want and "bfloat16" in got and "float32" in got
    for x, y in zip(tree_flatten(params)[0], tree_flatten(cast)[0]):
        assert torch.equal(x.to(y.dtype), y)
    f32 = get_model(configs.get_smoke_config(arch), device="cpu")
    assert f32.cast_for_compute(params) is params  # compute dtype == param dtype


def test_flash_attention_refuses_autograd_as_the_reference_does(setup):
    """The reference's Pallas K3 has no VJP: ``jax.grad`` through
    ``Model(use_flash=True).loss`` fails.  The port's K3 raises under
    autograd on the CPU too (and on the card: tests/test_torch_cuda.py),
    where it used to return an output with no gradient on the card."""
    cfg = setup["cfg"]
    jb = setup["jstream"].batch(0)
    jflash = j_get_model(j_configs.get_smoke_config(ARCH), use_flash=True)
    with pytest.raises(Exception):
        jax.grad(lambda p: jflash.loss(p, jb)[0])(setup["jparams"])
    flash = get_model(cfg, use_flash=True, device="cpu")
    with pytest.raises(NotImplementedError, match="no backward"):
        ts._value_and_grad(lambda p, b: flash.loss(p, b), setup["params"],
                           setup["stream"].batch(0))
    with torch.no_grad():  # the forward pass is unchanged
        got, _ = flash.loss(setup["params"], setup["stream"].batch(0))
    want, _ = setup["model"].loss(setup["params"], setup["stream"].batch(0))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_jax():
    ocfg = dict(peak_lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg, cfg = j_opt.OptimizerConfig(**ocfg), opt_lib.OptimizerConfig(**ocfg)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = opt_lib.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        want = float(j_opt.lr_schedule(jcfg, jnp.asarray(step)))
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert float(opt_lib.lr_schedule(cfg, torch.tensor(0))) == 0.0
    assert float(opt_lib.lr_schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(opt_lib.lr_schedule(cfg, torch.tensor(100))) == pytest.approx(0.1)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_apply_updates_matches_jax_on_identical_grads(setup, jax_fns, compress):
    ocfg = dict(OCFG, warmup_steps=2, compress_grads=compress)
    jcfg, cfg = j_opt.OptimizerConfig(**ocfg), opt_lib.OptimizerConfig(**ocfg)
    _, jg = jax_fns("value_and_grad", remat="none")(setup["jparams"], setup["jstream"].batch(0))
    grads = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jg), setup["cfg"], "cpu")
    jp, jstate = setup["jparams"], j_opt.init_opt_state(setup["jparams"], jcfg)
    tp, tstate = setup["params"], _opt_state_to_port(jstate, setup["cfg"])
    before = [x.clone() for x in tree_flatten((tp, tstate, grads))[0]]
    for _ in range(3):  # the moments and the error carry over steps
        jp, jstate, jm = j_opt.apply_updates(jp, jg, jstate, jcfg)
        tp, tstate, tm = opt_lib.apply_updates(tp, grads, tstate, cfg)
        for got, want in zip(_leaves((tp, tstate)), _leaves((jp, jstate)), strict=True):
            np.testing.assert_allclose(got, want, **UPDATE_TOL)
        assert set(tm) == set(jm)
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
        # the port's state is the reference's, tree and dtypes included
        back = _opt_state_to_port(jax.tree.map(np.asarray, jstate), setup["cfg"])
        assert [x.dtype for x in tree_flatten(back)[0]] == [
            x.dtype for x in tree_flatten(tstate)[0]]
    assert tstate["step"].dtype == torch.int32 and int(tstate["step"]) == 3
    # functional: the inputs of the first step are untouched
    first = opt_lib.init_opt_state(setup["params"], cfg)
    for x, y in zip(before, tree_flatten((setup["params"], first, grads))[0]):
        assert torch.equal(x, y)


def test_int8_compression_error_feedback():
    g = {"g": torch.from_numpy(np.random.default_rng(0).normal(size=128).astype(np.float32)) * 0.01}
    err = {"g": torch.zeros(128)}
    total = torch.zeros(128)
    for _ in range(50):
        restored, err = opt_lib.compress_with_feedback(g, err)
        total = total + restored["g"]
    np.testing.assert_allclose(total.numpy(), g["g"].numpy() * 50, rtol=0.02, atol=1e-4)


def test_opt_state_interop_round_trips_and_rejects_a_foreign_tree(setup):
    """AdamW state and params cross to the port and back (``to_numpy``)
    with every value and dtype kept; a tree with a missing leaf raises."""
    ocfg = j_opt.OptimizerConfig(compress_grads=True)
    jstate = jax.tree.map(np.asarray, j_opt.init_opt_state(setup["jparams"], ocfg))
    jstate["step"] = np.asarray(7, np.int32)
    jstate["mu"] = jax.tree.map(lambda x: np.full_like(x, 0.5), jstate["mu"])
    back = interop.to_numpy(interop.opt_state_from_numpy(jstate, setup["cfg"], "cpu"))
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jstate), strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(jax.tree.leaves(interop.to_numpy(setup["params"])),
                         jax.tree.leaves(setup["jparams"]), strict=True):
        np.testing.assert_array_equal(got, np.asarray(want))
    del jstate["nu"]["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        interop.opt_state_from_numpy(jstate, setup["cfg"], "cpu")


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def test_grad_accumulation_equivalence(setup, jax_fns):
    """4 microbatches == one batch of 4 (the reference's tolerance), and
    the 4-microbatch step's loss equals the JAX one's."""
    ocfg = opt_lib.OptimizerConfig(**OCFG)
    one = ts.make_train_step(setup["model"], ts.TrainConfig(microbatches=1, remat="none",
                                                            opt=ocfg))
    four = ts.make_train_step(setup["model"], ts.TrainConfig(microbatches=4, remat="none",
                                                             opt=ocfg))
    s0 = opt_lib.init_opt_state(setup["params"], ocfg)
    batch = setup["stream"].batch(0)
    p1, _, m1 = one(setup["params"], s0, batch)
    p4, _, m4 = four(setup["params"], s0, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    for a, b in zip(_leaves(p1), _leaves(p4)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5)
    j4 = jax_fns("step", microbatches=4)
    _, _, jm4 = j4(setup["jparams"], j_opt.init_opt_state(setup["jparams"], j_opt.OptimizerConfig(
        **OCFG)), setup["jstream"].batch(0))
    np.testing.assert_allclose(float(m4["loss"]), float(jm4["loss"]), **LOSS_TOL)
    with pytest.raises(ValueError, match="microbatches"):
        ts.make_train_step(setup["model"], ts.TrainConfig(microbatches=3, opt=ocfg))(
            setup["params"], s0, batch)


def test_loss_trajectory_matches_jax_step_by_step(setup, jax_fns):
    """Ten JAX steps; at each, the port's loss and gradients on the JAX
    step's own state and batch, and the port's own run's losses."""
    jstep = jax_fns("step")
    ocfg = opt_lib.OptimizerConfig(**OCFG)
    tstep = ts.make_train_step(setup["model"], ts.TrainConfig(remat="dots", opt=ocfg))
    jp, jo = setup["jparams"], j_opt.init_opt_state(setup["jparams"], j_opt.OptimizerConfig(
        **OCFG))
    tp, to = setup["params"], opt_lib.init_opt_state(setup["params"], ocfg)
    loss_fn = ts.make_loss_fn(setup["model"], ts.TrainConfig(remat="none"))
    jvg = jax_fns("value_and_grad", remat="none")
    j_losses, t_losses = [], []
    for i in range(10):
        jb, tb = setup["jstream"].batch(i), setup["stream"].batch(i)
        (jl, _), jg = jvg(jp, jb)
        here = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), setup["cfg"], "cpu")
        (tl, _), tg = ts._value_and_grad(loss_fn, here, tb)
        np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
        _grads_close(tg, jg)
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
    # The port's own run: the same losses while the parameters agree to
    # the Adam step's sign flips (see the module docstring).
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    assert t_losses[-1] < t_losses[0]


def test_loss_decreases(setup):
    ocfg = opt_lib.OptimizerConfig(peak_lr=1e-2, warmup_steps=5, total_steps=60)
    step = ts.make_train_step(setup["model"], ts.TrainConfig(opt=ocfg))
    p, state = setup["params"], opt_lib.init_opt_state(setup["params"], ocfg)
    losses = []
    for i in range(60):
        p, state, m = step(p, state, setup["stream"].batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_bf16_training_loss_decreases_with_f32_masters():
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), compute_dtype="bfloat16")
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ocfg = opt_lib.OptimizerConfig(peak_lr=1e-2, warmup_steps=5, total_steps=60)
    step = ts.make_train_step(model, ts.TrainConfig(opt=ocfg))
    state = opt_lib.init_opt_state(params, ocfg)
    stream = data_lib.SyntheticStream(model, SHAPE)
    losses = []
    for i in range(60):
        params, state, m = step(params, state, stream.batch(i))
        losses.append(float(m["loss"]))
    assert params["layers"]["attn"]["wq"].dtype == torch.float32
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_eval_step_matches_the_loss(setup):
    ev = ts.make_eval_step(setup["model"], ts.TrainConfig(remat="none"))
    m = ev(setup["params"], setup["stream"].batch(1))
    want, _ = setup["jm"].loss(setup["jparams"], setup["jstream"].batch(1))
    np.testing.assert_allclose(float(m["loss"]), float(want), **LOSS_TOL)
    assert set(m) == {"loss", "ce", "moe_aux_loss"}


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _state(setup, ocfg=None):
    ocfg = ocfg or opt_lib.OptimizerConfig()
    return setup["params"], opt_lib.init_opt_state(setup["params"], ocfg)


def test_checkpoint_roundtrip(tmp_path, setup):
    c = ckpt_lib.Checkpointer(str(tmp_path), async_save=False)
    c.save(3, setup["params"])
    assert c.latest_step() == 3
    restored = c.restore(3, like=setup["params"])
    for a, b in zip(tree_flatten(setup["params"])[0], tree_flatten(restored)[0]):
        assert torch.equal(a, b)


def test_corrupt_checkpoint_is_skipped(tmp_path, setup):
    c = ckpt_lib.Checkpointer(str(tmp_path), async_save=False)
    c.save(1, setup["params"])
    c.save(2, setup["params"])
    with open(tmp_path / "step_00000002" / "arrays.npz", "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef" * 8)
    assert c.latest_step() == 1


def test_async_save_joins_and_copies_before_returning(tmp_path, setup):
    c = ckpt_lib.Checkpointer(str(tmp_path), async_save=True)
    tree = {"w": torch.ones(64, 64)}
    c.save(5, tree)
    tree["w"].add_(1.0)  # a later in-place write must not reach the checkpoint
    c.wait()
    assert c.latest_step() == 5
    assert torch.equal(c.restore(5, like=tree)["w"], torch.ones(64, 64))


def test_gc_keeps_k(tmp_path, setup):
    c = ckpt_lib.Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        c.save(s, setup["params"])
    assert c.all_steps() == [3, 4]


def test_same_tree_same_manifest_in_both_packages(tmp_path, setup):
    """Keys, shapes, dtype names and digest of (params, opt state) equal
    the JAX package's for the same values."""
    jstate = j_opt.init_opt_state(setup["jparams"], j_opt.OptimizerConfig())
    j_ckpt.Checkpointer(str(tmp_path / "j"), async_save=False).save(
        1, (setup["jparams"], jstate), extra={"a": 1})
    ckpt_lib.Checkpointer(str(tmp_path / "t"), async_save=False).save(
        1, (setup["params"], _opt_state_to_port(jstate, setup["cfg"])), extra={"a": 1})
    want = json.loads((tmp_path / "j" / "step_00000001" / "manifest.json").read_text())
    got = json.loads((tmp_path / "t" / "step_00000001" / "manifest.json").read_text())
    assert got == want


def test_jax_checkpoint_restores_in_the_port_and_trains_on(tmp_path, setup, jax_fns):
    """A JAX-written (params, opt state) after two steps restores in the
    port, and the next step's loss equals the JAX next step's."""
    jstep = jax_fns("step")
    jp, jo = setup["jparams"], j_opt.init_opt_state(setup["jparams"], j_opt.OptimizerConfig(
        **OCFG))
    for i in range(2):
        jp, jo, _ = jstep(jp, jo, setup["jstream"].batch(i))
    jc = j_ckpt.Checkpointer(str(tmp_path), async_save=False)
    jc.save(2, (jp, jo))
    c = ckpt_lib.Checkpointer(str(tmp_path), async_save=False)
    assert c.latest_step() == 2
    tp, to = c.restore(2, like=_state(setup, opt_lib.OptimizerConfig(**OCFG)))
    for got, want in zip(_leaves((tp, to)), _leaves((jp, jo)), strict=True):
        np.testing.assert_array_equal(got, want)
    tstep = ts.make_train_step(setup["model"], ts.TrainConfig(
        remat="none", opt=opt_lib.OptimizerConfig(**OCFG)))
    _, _, tm = tstep(tp, to, setup["stream"].batch(2))
    _, _, jm = jstep(jp, jo, setup["jstream"].batch(2))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)


def test_port_checkpoint_restores_in_jax_and_trains_on(tmp_path, setup, jax_fns):
    ocfg = opt_lib.OptimizerConfig(**OCFG)
    tstep = ts.make_train_step(setup["model"], ts.TrainConfig(remat="none", opt=ocfg))
    tp, to = _state(setup, ocfg)
    for i in range(2):
        tp, to, _ = tstep(tp, to, setup["stream"].batch(i))
    ckpt_lib.Checkpointer(str(tmp_path), async_save=False).save(2, (tp, to))
    jc = j_ckpt.Checkpointer(str(tmp_path), async_save=False)
    assert jc.latest_step() == 2
    like = (setup["jparams"], j_opt.init_opt_state(setup["jparams"], j_opt.OptimizerConfig(
        **OCFG)))
    jp, jo = jc.restore(2, like=like)
    for got, want in zip(_leaves((jp, jo)), _leaves((tp, to)), strict=True):
        np.testing.assert_array_equal(got, want)
    _, _, jm = jax_fns("step")(jp, jo, setup["jstream"].batch(2))
    _, _, tm = tstep(tp, to, setup["stream"].batch(2))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)


def test_bf16_and_key_leaves_round_trip_across_packages(tmp_path):
    """bfloat16 leaves are stored as JAX stores them (raw bits as numpy
    ``V2``, ``"bfloat16"`` in the manifest) and threefry keys keep their
    bits (int32 in the port, uint32 in JAX).  The port restores both
    packages' bf16 leaves; JAX's own ``restore`` cannot cast ``V2`` back to
    bfloat16, for its checkpoints and the port's alike."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    keys = rng.integers(0, 2**32, size=(4, 2), dtype=np.uint64).astype(np.uint32)
    jtree = {"w": jnp.asarray(x, jnp.bfloat16), "key": jnp.asarray(keys)}
    ttree = {"w": torch.from_numpy(x).to(torch.bfloat16),
             "key": interop.keys_from_numpy(keys, "cpu")}
    j_ckpt.Checkpointer(str(tmp_path / "j"), async_save=False).save(1, jtree)
    c = ckpt_lib.Checkpointer(str(tmp_path / "t"), async_save=False)
    c.save(1, ttree)
    with np.load(tmp_path / "j" / "step_00000001" / "arrays.npz") as jz, \
            np.load(tmp_path / "t" / "step_00000001" / "arrays.npz") as tz:
        assert jz["w"].dtype == tz["w"].dtype == np.dtype("V2")
        assert jz["w"].tobytes() == tz["w"].tobytes()
        np.testing.assert_array_equal(tz["key"].view(np.uint32), jz["key"])
    man, jman = c.manifest(1)["keys"], j_ckpt.Checkpointer(str(tmp_path / "j")).manifest(1)["keys"]
    assert man["w"] == jman["w"] == {"shape": [3, 5], "dtype": "bfloat16"}
    for src in ("j", "t"):
        got = ckpt_lib.Checkpointer(str(tmp_path / src)).restore(1, like=ttree)
        assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], ttree["w"])
        np.testing.assert_array_equal(interop.keys_to_numpy(got["key"]), keys)
        jc = j_ckpt.Checkpointer(str(tmp_path / src))
        np.testing.assert_array_equal(
            np.asarray(jc.restore(1, like={"key": jtree["key"]})["key"]), keys)
        with pytest.raises(ValueError, match="cast"):
            jc.restore(1, like=jtree)
    c.save(2, dict(ttree, n=7, host=np.arange(3, dtype=np.int32)))  # Python and numpy leaves
    back = c.restore(2, like=dict(ttree, n=0, host=np.zeros(3, np.int32)))
    assert back["n"] == 7 and back["host"].tolist() == [0, 1, 2]


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A ``(data 1, model 1)`` DeviceMesh in a one-rank gloo group of this
    process, torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        yield mesh_lib.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        mesh_lib._make_mesh.cache_clear()
        dist.destroy_process_group()


def test_restore_checks_shapes_and_refuses_shardings(tmp_path, one_rank_mesh):
    """Shapes and keys are checked; ``shardings=`` places each leaf as a
    DTensor by its NamedSharding (sharded saving and restoring over ranks:
    tests/test_torch_model_sharding.py)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import sharding as sh

    c = ckpt_lib.Checkpointer(str(tmp_path / "ck"), async_save=False)
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    c.save(1, {"w": w})
    with pytest.raises(ValueError, match="shape"):
        c.restore(1, like={"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing"):
        c.restore(1, like={"v": torch.zeros(3)})
    got = c.restore(1, like={"w": torch.zeros(2, 3)},
                    shardings={"w": sh.NamedSharding(one_rank_mesh, ("data", "model"))})
    assert isinstance(got["w"], DTensor) and torch.equal(got["w"].full_tensor(), w)
    c.save(2, got)  # a DTensor tree saves its logical arrays
    assert torch.equal(c.restore(2, like={"w": torch.zeros(2, 3)})["w"], w)


# ---------------------------------------------------------------------------
# The restart loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loop_parts(setup):
    ocfg = opt_lib.OptimizerConfig(**OCFG)
    raw = ts.make_train_step(setup["model"], ts.TrainConfig(remat="none", opt=ocfg))
    stream = setup["stream"]

    def step_fn(state, i):
        p, o = state
        p, o, m = raw(p, o, stream.batch(i))
        return (p, o), m

    return step_fn, _state(setup, ocfg)


def _equal(a, b) -> None:
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)


def test_restart_recovers_and_replays_bit_exact(tmp_path, loop_parts):
    step_fn, state = loop_parts
    truth, rep0 = ft.ResilientLoop(
        step_fn, ckpt_lib.Checkpointer(str(tmp_path / "a"), async_save=False),
        save_every=10).run(state, 30)
    assert rep0.restarts == 0
    fails = {13, 27}

    def failure_hook(i):
        if i in fails:
            fails.remove(i)
            raise RuntimeError("simulated node failure")

    recovered, rep = ft.ResilientLoop(
        step_fn, ckpt_lib.Checkpointer(str(tmp_path / "b")), save_every=10).run(
        state, 30, failure_hook=failure_hook)
    assert rep.restarts == 2 and rep.final_step == 30
    _equal(truth, recovered)
    # the replayed steps' losses are the first run's, bit for bit
    assert rep.losses[:13] == rep0.losses[:13]
    assert rep.losses[13:23] == rep0.losses[10:20]


def test_fresh_loop_resumes_from_checkpoint(tmp_path, loop_parts):
    step_fn, state = loop_parts
    truth, _ = ft.ResilientLoop(
        step_fn, ckpt_lib.Checkpointer(str(tmp_path / "t"), async_save=False),
        save_every=10).run(state, 30)
    ft.ResilientLoop(step_fn, ckpt_lib.Checkpointer(str(tmp_path / "r"), async_save=False),
                     save_every=10).run(state, 20)
    resumed, rep = ft.ResilientLoop(
        step_fn, ckpt_lib.Checkpointer(str(tmp_path / "r"), async_save=False),
        save_every=10).run(state, 30)
    assert rep.final_step == 30 and len(rep.losses) == 10
    _equal(truth, resumed)


def test_max_restarts_exceeded_reraises(tmp_path, loop_parts):
    step_fn, state = loop_parts
    loop = ft.ResilientLoop(step_fn, ckpt_lib.Checkpointer(str(tmp_path), async_save=False),
                            save_every=10, max_restarts=2)

    def always_fail(i):
        if i == 5:
            raise RuntimeError("persistent node failure")

    with pytest.raises(RuntimeError, match="persistent"):
        loop.run(state, 30, failure_hook=always_fail)


def test_straggler_detection():
    pol = ft.StragglerPolicy(threshold=2.0, warmup=3)
    for i in range(10):
        assert not pol.observe(i, 0.1)
    assert pol.observe(10, 0.5)
    assert len(pol.flagged) == 1
    assert not pol.observe(11, 0.12)


def test_reshard_moves_every_tensor_leaf(setup):
    moved = ft.reshard((setup["params"], {"n": 3}), "meta")
    assert all(x.device.type == "meta" for x in tree_flatten(moved[0])[0])
    assert moved[1] == {"n": 3}
    back = ft.reshard(setup["params"], "cpu")
    _equal(back, setup["params"])


# ---------------------------------------------------------------------------
# The launcher and the example
# ---------------------------------------------------------------------------


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", ARCH, "--steps", "12", "--seq-len", "32", "--global-batch", "4",
            "--save-every", "5", "--log-every", "4", "--remat", "dots",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "done: final_step=12 restarts=0" in out
    assert ckpt_lib.Checkpointer(str(tmp_path)).latest_step() == 12
    assert launch_train.main(argv) == 0  # resumes at the end: no step runs
    assert "final_step=12" in capsys.readouterr().out


def test_launcher_matches_the_jax_launcher(tmp_path):
    """``build_trainer`` wires the reference's schedule and shapes: the
    same config, one step each from the same weights gives the same loss."""
    from repro.launch import train as j_launch

    kw = dict(seq_len=32, global_batch=4, steps=40, lr=3e-3, microbatches=2, remat="full",
              smoke=True)
    jmodel, jp, jo, jstep, jstream = j_launch.build_trainer(ARCH, **kw)
    model, tp, to, tstep, tstream = launch_train.build_trainer(ARCH, device="cpu", **kw)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), model.cfg, "cpu")
    _, _, jm = jstep(jp, jo, jstream.batch(0))
    _, _, tm = tstep(tp, to, tstream.batch(0))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert model.device.type == "cpu"


def test_launcher_trains_on_a_mesh(one_rank_mesh):
    """``build_trainer(mesh=)`` places the parameters and optimizer state
    as DTensors by the rules and each batch by ``batch_shardings``; on a
    one-rank mesh its step (two microbatches, full remat) is the unsharded
    step's (four ranks: tests/test_torch_model_sharding.py)."""
    from torch.distributed.tensor import DTensor

    kw = dict(seq_len=32, global_batch=4, steps=40, lr=3e-3, microbatches=2, remat="full",
              smoke=True, device="cpu")
    model, p, o, step, stream = launch_train.build_trainer(ARCH, **kw)
    smodel, sp, so, sstep, _ = launch_train.build_trainer(ARCH, mesh=one_rank_mesh, **kw)
    assert smodel.axis_rules["mesh"] is one_rank_mesh and model.axis_rules is None
    assert all(isinstance(x, DTensor) for x in tree_flatten((sp, so))[0])
    _, _, m = step(p, o, stream.batch(0))
    new_p, _, sm = sstep(sp, so, stream.batch(0))
    np.testing.assert_allclose(float(sm["loss"]), float(m["loss"]), **LOSS_TOL)
    assert isinstance(new_p["layers"]["attn"]["wq"], DTensor)
    # int8 gradient compression with error feedback runs on DTensor trees too
    kw.update(microbatches=1, remat="none", compress_grads=True)
    _, p, o, step, _ = launch_train.build_trainer(ARCH, **kw)
    _, sp, so, sstep, _ = launch_train.build_trainer(ARCH, mesh=one_rank_mesh, **kw)
    new_p, new_o, m = step(p, o, stream.batch(0))
    snew_p, snew_o, sm = sstep(sp, so, stream.batch(0))
    for k in ("loss", "compress_error_norm"):
        np.testing.assert_allclose(float(sm[k]), float(m[k]), rtol=1e-5)
    np.testing.assert_allclose(snew_o["error"]["embed"]["embedding"].full_tensor().numpy(),
                               new_o["error"]["embed"]["embedding"].numpy(), rtol=1e-5,
                               atol=1e-7)


def test_launcher_defaults_to_the_card(monkeypatch, tmp_path):
    """No ``--device`` and no CUDA: the launcher refuses to train on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", ARCH, "--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)

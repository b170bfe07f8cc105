"""The port's dense LM (``repro_torch.models``, ``serve.steps``) against the
JAX package on the float32 smoke configs of SmolLM-135M and Qwen3-0.6B
(``qk_norm`` and an explicit ``head_dim``), with the JAX weights carried
across by ``interop.lm_params_from_numpy``.

Layers, ``Model.forward`` with and without K3 (``use_flash``),
``decode_step`` (logits and cache) over a ring cache that fills and wraps,
and ``make_prefill_step`` are held to the JAX package within 1e-5 (float32
sums taken in another order; logits and activations are O(1)).  The JAX
side is computed once per config in a module-scoped fixture.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serve import steps as j_steps  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serve import steps  # noqa: E402

ARCHS = ["smollm-135m", "qwen3-0.6b"]
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, W, DECODE_STEPS = 2, 32, 16, 20


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """One config's JAX model, weights (both packages) and JAX results."""
    name = request.param
    jcfg, cfg = j_configs.get_smoke_config(name), configs.get_smoke_config(name)
    jm = j_get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    res = {
        "forward": {f: np.asarray(j_get_model(jcfg, use_flash=f).forward(
            params, {"tokens": jnp.asarray(tokens)})[0]) for f in (False, True)},
        "prefill": np.asarray(j_steps.make_prefill_step(j_get_model(jcfg, use_flash=True))(
            params, {"tokens": jnp.asarray(tokens)})),
    }
    # Decode: the second sequence lags, so the two fill the ring differently
    # and the first wraps past W.
    cache = jm.init_cache(B, W)
    logits = []
    for step in range(DECODE_STEPS):
        pos = np.array([step, max(step - 5, 0)], np.int32)
        lg, cache = jm.decode_step(params, cache, jnp.asarray(tokens[:, step]), jnp.asarray(pos))
        logits.append(np.asarray(lg))
    res["decode"] = (np.stack(logits), jax.tree.map(np.asarray, cache))
    lp = jax.tree.map(lambda t: t[0], params["layers"])
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    res["layers"] = {
        "norm": np.asarray(JL.norm(lp["ln1"], jnp.asarray(x), jcfg)),
        "swiglu": np.asarray(JL.swiglu(lp["mlp"], jnp.asarray(x))),
        "attention": {f: np.asarray(JL.attention(lp["attn"], jnp.asarray(x), jcfg, pos,
                                                 use_flash=f)) for f in (False, True)},
        "embed": np.asarray(JL.embed(params["embed"], jnp.asarray(tokens), jcfg)),
        "unembed": np.asarray(JL.unembed(params["embed"], jnp.asarray(x), jcfg)),
    }
    jcache = JL.init_kv_cache(jcfg, B, W, jnp.float32)
    dpos = jnp.asarray([3, W + 2], jnp.int32)
    out, new = JL.attention_decode(lp["attn"], jnp.asarray(x[:, :1]), jcfg, jcache, dpos)
    res["attention_decode"] = (np.asarray(out), jax.tree.map(np.asarray, new))
    lp_t = jax.tree.map(lambda t: torch.from_numpy(np.array(t)), lp)
    return dict(cfg=cfg, jcfg=jcfg, params=tparams, tokens=tokens, x=x, lp=lp_t, res=res)


@pytest.mark.parametrize("use_flash", [False, True], ids=["blocked", "flash"])
def test_forward_matches_jax(arch, use_flash):
    model = get_model(arch["cfg"], use_flash=use_flash, device="cpu")
    logits, _ = model.forward(arch["params"], {"tokens": torch.from_numpy(arch["tokens"])})
    assert logits.shape == (B, S, arch["cfg"].vocab_size)
    _close(logits, arch["res"]["forward"][use_flash])


def test_prefill_step_matches_jax(arch):
    step = steps.make_prefill_step(get_model(arch["cfg"], use_flash=True, device="cpu"))
    out = step(arch["params"], {"tokens": torch.from_numpy(arch["tokens"])})
    assert out.dtype == torch.float32 and out.shape == (B, arch["cfg"].vocab_size)
    _close(out, arch["res"]["prefill"])


def test_decode_steps_match_jax_logits_and_cache(arch):
    model = get_model(arch["cfg"], device="cpu")
    cache = model.init_cache(B, W)
    tokens = arch["tokens"]
    logits = []
    for step in range(DECODE_STEPS):
        pos = torch.tensor([step, max(step - 5, 0)], dtype=torch.int32)
        lg, new = model.decode_step(arch["params"], cache, torch.from_numpy(tokens[:, step]), pos)
        assert new is not cache and lg.dtype == torch.float32
        cache = new
        logits.append(lg)
    want_logits, want_cache = arch["res"]["decode"]
    _close(torch.stack(logits), want_logits)
    for leaf in ("k", "v"):
        assert cache["kv"][leaf].shape == want_cache["kv"][leaf].shape
        _close(cache["kv"][leaf], want_cache["kv"][leaf])


def test_decode_step_does_not_write_the_cache_passed_in(arch):
    model = get_model(arch["cfg"], device="cpu")
    cache = model.init_cache(B, W)
    model.decode_step(arch["params"], cache, torch.ones(B, dtype=torch.int32),
                      torch.zeros(B, dtype=torch.int32))
    assert all((t == 0).all() for t in cache["kv"].values())


def test_layers_match_jax(arch):
    cfg, lp, x, res = arch["cfg"], arch["lp"], torch.from_numpy(arch["x"]), arch["res"]["layers"]
    tokens = torch.from_numpy(arch["tokens"])
    pos = torch.arange(S)[None].expand(B, S)
    _close(TL.norm(lp["ln1"], x, cfg), res["norm"])
    _close(TL.swiglu(lp["mlp"], x), res["swiglu"])
    for flash in (False, True):
        _close(TL.attention(lp["attn"], x, cfg, pos, use_flash=flash), res["attention"][flash])
    _close(TL.embed(arch["params"]["embed"], tokens, cfg), res["embed"])
    _close(TL.unembed(arch["params"]["embed"], x, cfg), res["unembed"])


def test_attention_decode_matches_jax(arch):
    """One decode step into an empty cache at position 3 and, for the
    second sequence, past the window (ring slot 2)."""
    cfg, lp = arch["cfg"], arch["lp"]
    cache = TL.init_kv_cache(cfg, B, W, torch.float32, "cpu")
    pos = torch.tensor([3, W + 2], dtype=torch.int32)
    out, new = TL.attention_decode(lp["attn"], torch.from_numpy(arch["x"][:, :1]), cfg, cache, pos)
    want_out, want_cache = arch["res"]["attention_decode"]
    _close(out, want_out)
    for leaf in ("k", "v"):
        _close(new[leaf], want_cache[leaf])


def test_small_layers_match_jax():
    """Norm variants, RoPE and the GELU MLP on seeded inputs."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    _close(TL.rms_norm_simple(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           JL.rms_norm_simple(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    pos = rng.integers(0, 1000, (2, 8)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        tcos, tsin = TL.rope_angles(torch.from_numpy(pos), 16, theta)
        jcos, jsin = JL.rope_angles(jnp.asarray(pos), 16, theta)
        _close(tcos, jcos)
        _close(tsin, jsin)
        _close(TL.apply_rope(torch.from_numpy(x), tcos, tsin),
               JL.apply_rope(jnp.asarray(x), jcos, jsin))
    ln_cfg = dataclasses.replace(configs.get_smoke_config("smollm-135m"), norm="ln")
    jln = dataclasses.replace(j_configs.get_smoke_config("smollm-135m"), norm="ln")
    h = rng.normal(size=(2, 8, 64)).astype(np.float32)
    p = {"scale": rng.normal(size=(64,)).astype(np.float32),
         "bias": rng.normal(size=(64,)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(TL.norm(tp, torch.from_numpy(h), ln_cfg),
           JL.norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h), jln))
    mlp = JL.init_gelu_mlp(jax.random.PRNGKey(1), jln, 64, 128)
    tmlp = {k: torch.from_numpy(np.array(v)) for k, v in mlp.items()}
    _close(TL.gelu_mlp(tmlp, torch.from_numpy(h)), JL.gelu_mlp(mlp, jnp.asarray(h)))


def test_init_makes_the_jax_tree_and_cache_shapes(arch):
    """``Model.init`` makes the JAX pytree's structure, shapes and dtypes
    (``lm_params_from_numpy`` accepted the JAX weights against it), and the
    caches agree in shape and dtype."""
    cfg = arch["cfg"]
    model = get_model(cfg, device="cpu")
    own = model.init(torch.Generator().manual_seed(0))
    flat = {k: v.shape for k, v in _flatten(own).items()}
    assert flat == {k: v.shape for k, v in _flatten(arch["params"]).items()}
    jcache = j_get_model(arch["jcfg"]).init_cache(3, 8)
    tcache = model.init_cache(3, 8)
    for leaf in ("k", "v"):
        assert tuple(tcache["kv"][leaf].shape) == jcache["kv"][leaf].shape
        assert tcache["kv"][leaf].dtype == torch.float32


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_lm_params_from_numpy_rejects_a_foreign_tree(arch):
    tree = jax.tree.map(np.asarray, j_get_model(arch["jcfg"]).init(jax.random.PRNGKey(1)))
    del tree["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        interop.lm_params_from_numpy(tree, arch["cfg"], "cpu")


def test_serve_step_is_greedy_decode(arch):
    model = get_model(arch["cfg"], device="cpu")
    cache = model.init_cache(B, W)
    tok = torch.from_numpy(arch["tokens"][:, 0])
    pos = torch.zeros(B, dtype=torch.int32)
    new_tok, _ = steps.make_serve_step(model)(arch["params"], cache, tok, pos, None)
    logits, _ = model.decode_step(arch["params"], cache, tok, pos)
    assert torch.equal(new_tok, torch.argmax(logits, -1).to(torch.int32))


def test_unported_paths_raise():
    """Every family is ported: ``get_model`` takes vlm and audio, and the
    one path left that raises is the reference's own refusal, audio's decode."""
    for name in ("qwen2-vl-2b", "hubert-xlarge"):
        assert get_model(configs.get_smoke_config(name), device="cpu").cfg.family in ("vlm",
                                                                                      "audio")
    audio = get_model(configs.get_smoke_config("hubert-xlarge"), device="cpu")
    jaudio = j_get_model(j_configs.get_smoke_config("hubert-xlarge"))
    with pytest.raises(ValueError, match="audio has no decode path") as want:
        jaudio.init_cache(1, 4)
    with pytest.raises(ValueError, match=str(want.value)):
        audio.init_cache(1, 4)
    with pytest.raises(ValueError, match="unknown family"):
        get_model(dataclasses.replace(configs.get_smoke_config("smollm-135m"), family="rnn"),
                  device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """No device given and no CUDA: the model refuses to carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(configs.get_smoke_config("smollm-135m"))


def test_decode_window_and_registry():
    assert configs.list_archs() == sorted(j_configs.list_archs()) == [
        "deepseek-moe-16b", "hubert-xlarge", "qwen1.5-32b", "qwen2-vl-2b", "qwen3-0.6b",
        "qwen3-14b", "qwen3-moe-235b-a22b", "smollm-135m", "xlstm-350m", "zamba2-7b"]
    full = configs.get_config("smollm-135m")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size) == (30, 576, 9, 3, 64, 1536, 49_152)
    for name in configs.list_archs():
        assert configs.get_config(name) == _as_port(j_configs.get_config(name))
        for shape in configs.SHAPES.values():
            assert steps.decode_cache_window(configs.get_config(name), shape) == \
                j_steps.decode_cache_window(j_configs.get_config(name), shape)


def _as_port(jcfg):
    """The JAX package's ArchConfig as the port's (same fields, same values)."""
    return configs.ArchConfig(**dataclasses.asdict(jcfg))

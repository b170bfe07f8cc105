"""The port's int8 KV cache (``kv_cache_dtype="int8"``: ``_quantize_kv``,
``_dequantize_kv`` and the int8 branch of ``attention_decode`` in
``repro_torch.models.layers``) against the JAX package.

The quantizer bit for bit on the same float32 rows (a zero row included),
its round-trip bound over random scales and widths (the reference's own
property test), 20 int8 decode steps of the Qwen3-0.6B and Qwen2-VL-2B
float32 smoke configs past a 16-slot window (logits within 2e-3, the
reference's int8 tolerance; the int8 rows and their scales), and the
serving engine at 4 lanes on an int8 cache equal to its oracle.  The
JAX side runs once per config, in a module-scoped fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serve.engine import EngineConfig, GenerationEngine  # noqa: E402
from repro_torch.testing import engine_inputs  # noqa: E402
from tests import torch_parity as tp  # noqa: E402
from tests.test_torch_vlm import vlm_batch  # noqa: E402

INT8_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_models.py's int8 decode tolerance
ARCHS = {"qwen3-0.6b": None, "qwen2-vl-2b": vlm_batch}


def _rows() -> np.ndarray:
    """[3, 4, 16] float32 rows over six decades of scale, one row zero."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 4, 16)) * 10.0 ** rng.integers(-3, 4, (3, 4, 1))
    x[1, 2] = 0.0
    return x.astype(np.float32)


def test_quantize_matches_jax_bit_for_bit():
    x = _rows()
    q, s = L._quantize_kv(torch.from_numpy(x))
    jq, js = JL._quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16 and s.shape == (3, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js.astype(jnp.float32)))
    assert (q[1, 2] == 0).all()
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        back = L._dequantize_kv(q, s, dtype)
        want = JL._dequantize_kv(jq, js, jdtype)
        assert back.dtype == dtype
        np.testing.assert_array_equal(back.float().numpy(), np.asarray(want.astype(jnp.float32)))
        assert (back[1, 2] == 0).all()


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**16), scale=st.floats(1e-3, 1e3), dh=st.sampled_from([16, 64, 128]))
def test_quantize_roundtrip_error_bound(seed, scale, dh):
    """Symmetric int8: |x - deq(q(x))| <= amax/254 per row, plus the bf16
    rounding of the scale."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(4, dh)) * scale).astype(np.float32))
    q, s = L._quantize_kv(x)
    back = L._dequantize_kv(q, s, torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    bound = amax / 254.0 + amax * 0.005 + 1e-6
    assert bool(((back - x).abs() <= bound).all())


@pytest.fixture(scope="module", params=list(ARCHS))
def fam(request):
    c = tp.carry(request.param, batch=ARCHS[request.param], kv_cache_dtype="int8")
    c.update(tp.jax_decode(c))
    return c


def test_init_cache_is_int8_with_bf16_scales(fam):
    cfg = fam["cfg"]
    cache = fam["model"].init_cache(tp.B, tp.W)
    tp.assert_same_tree(cache, fam["cache"])
    kv = cache["kv"]
    assert list(kv) == ["k_q", "k_s", "v_q", "v_s"]
    shape = (cfg.num_layers, tp.B, tp.W, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert kv["k_q"].shape == kv["v_q"].shape == shape and kv["k_q"].dtype == torch.int8
    assert kv["k_s"].shape == kv["v_s"].shape == shape[:-1] and kv["k_s"].dtype == torch.bfloat16


def test_int8_decode_steps_match_jax(fam):
    logits, cache = tp.port_decode(fam)
    tp.close(logits, fam["decode"], **INT8_TOL)
    tp.assert_trees_close(cache, fam["cache"], **INT8_TOL)


@pytest.mark.parametrize("fam", ["qwen2-vl-2b"], indirect=True)
def test_engine_on_an_int8_cache_equals_its_oracle(fam):
    kw = dict(lanes=4, max_context=16, max_prompt_len=6, max_new_tokens=6,
              requests_per_lane=2, eos_id=0)
    prompts, plens = engine_inputs(EngineConfig(**kw), fam["cfg"].vocab_size, seed=0)
    eng = GenerationEngine(fam["model"], fam["params"], EngineConfig(**kw))
    assert any(spec.dtype == torch.int8 for spec in eng.member_specs)
    got = eng.generate(prompts, plens)
    want = eng.reference_generate(prompts, plens)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert got["lengths"].sum() > 0

"""The port's flash attention (K3) on the CPU against the JAX package's
Pallas kernel in interpret mode, at the shapes of tests/test_kernels.py:
float32 within 2e-5 (both compute in float32, in another order) and bf16
within 3e-2 (the same bound as the JAX package's own bf16 test).  Also the
wrapper's refusals: causal attention with ``S != T`` (the kernel's mask is
top-left aligned, the JAX ``ref.py``'s bottom-right), tiles that do not
divide the sequence, and a failed build on a device tensor; the choice
between the two CUDA kernels (tensor cores for bf16 with Dh 64 or 128,
CUDA cores otherwise) and the 16-byte layout check of the first.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
checked on a card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as j_ops  # noqa: E402
from repro_torch.kernels import _layout  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as t_ref  # noqa: E402
from repro_torch.testing import attention_inputs  # noqa: E402

# (b, s, t, h, hk, dh, causal, dtype)
CASES = {
    "f32-2x64-h4-g2-d16": (2, 64, 64, 4, 2, 16, True, "float32"),
    "f32-1x128-h8-g1-d32": (1, 128, 128, 8, 8, 32, True, "float32"),
    "f32-2x32-h4-g4-d64": (2, 32, 32, 4, 1, 64, True, "float32"),
    "f32-1x256-h2-g1-d128": (1, 256, 256, 2, 2, 128, True, "float32"),
    "f32-noncausal": (1, 64, 64, 4, 4, 16, False, "float32"),
    "f32-noncausal-s-ne-t": (1, 32, 64, 4, 2, 16, False, "float32"),
    "bf16-1x64-h4-g2-d32": (1, 64, 64, 4, 2, 32, True, "bfloat16"),
}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _inputs(case):
    b, s, t, h, hk, dh, _, dtype = CASES[case]
    q, k, v = attention_inputs(b, s, t, h, hk, dh, seed=len(case))
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return tuple(x.to(tdt) for x in (q, k, v))


def _jax(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


@pytest.fixture(scope="module")
def jax_out():
    """The Pallas kernel (interpret mode, 32 x 32 tiles) on every case."""
    out = {}
    for case, (*_, causal, _dtype) in CASES.items():
        q, k, v = (_jax(x) for x in _inputs(case))
        res = j_ops.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
        out[case] = np.asarray(res, np.float32)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_matches_pallas_kernel(jax_out, case):
    *_, causal, dtype = CASES[case]
    q, k, v = _inputs(case)
    before = t_ops.flash_attention.launches
    got = t_ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert t_ops.flash_attention.launches == before  # CPU calls launch nothing
    np.testing.assert_allclose(got.float().numpy(), jax_out[case], **TOL[dtype])


def test_plain_version_is_the_wrappers_cpu_path():
    q, k, v = _inputs("f32-2x64-h4-g2-d16")
    assert torch.equal(t_ops.flash_attention(q, k, v), t_ref.attention(q, k, v))


@pytest.mark.parametrize("fn", [t_ops.flash_attention, t_ref.attention], ids=["ops", "ref"])
def test_causal_with_s_ne_t_raises(fn):
    q, k, v = attention_inputs(1, 32, 64, 4, 2, 16)
    with pytest.raises(ValueError, match="S == T"):
        fn(q, k, v, causal=True)


@pytest.mark.parametrize("s", [96, 200])
def test_rejects_a_sequence_the_tile_does_not_divide(s):
    q, k, v = attention_inputs(1, s, s, 2, 1, 16)
    with pytest.raises(ValueError, match="tile"):
        t_ops.flash_attention(q, k, v)


def test_rejects_mismatched_heads_and_dtypes():
    q, k, v = attention_inputs(1, 32, 32, 4, 3, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        t_ops.flash_attention(q, k, v)
    q, k, v = attention_inputs(1, 32, 32, 4, 2, 16)
    with pytest.raises(TypeError, match="dtypes"):
        t_ops.flash_attention(q, k.to(torch.bfloat16), v)


def test_device_tensor_raises_when_the_build_fails(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: with a
    failing build the wrapper raises instead of running the plain version.
    Meta tensors stand in for the card's here (this machine may have none)."""

    def failing_build():
        raise RuntimeError("nvcc failed building flash_attention")

    monkeypatch.setattr(t_kernel, "library", failing_build)
    q = torch.zeros((1, 64, 4, 16), device="meta")
    kv = torch.zeros((1, 64, 2, 16), device="meta")
    before = t_ops.flash_attention.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        t_ops.flash_attention(q, kv, kv)
    assert t_ops.flash_attention.launches == before


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 16, "sm90"), (torch.bfloat16, 32, "sm90"),
    (torch.bfloat16, 80, "sm90"), (torch.bfloat16, 112, "sm90"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 128, "cuda_cores"),
    (torch.float32, 80, "cuda_cores"), (torch.float32, 112, "cuda_cores"),
], ids=str)
def test_route_depends_on_dtype_and_head_dim_only(dtype, dh, want):
    """Every head dim the kernels take is routed by its dtype alone."""
    assert dh in t_kernel.HEAD_DIMS
    assert t_kernel.route(dtype) == want


@pytest.mark.parametrize("wrapper,dtype", [
    ("flash_attention", torch.bfloat16), ("flash_attention", torch.float16),
    ("flash_attention_sm90", torch.float32), ("flash_attention_sm90", torch.float16),
], ids=str)
def test_kernel_wrapper_refuses_another_dtype(monkeypatch, wrapper, dtype):
    """Each kernel's wrapper takes its own element type only, before it
    builds or launches anything."""
    def no_build():
        raise AssertionError("built a kernel library for the wrong dtype")

    monkeypatch.setattr(t_kernel, "library", no_build)
    monkeypatch.setattr(t_kernel, "library_sm90", no_build)
    q = torch.zeros((1, 64, 4, 64), dtype=dtype, device="meta")
    with pytest.raises(TypeError, match="takes"):
        getattr(t_kernel, wrapper)(q, q, q, causal=True)


@pytest.mark.parametrize("ptr,strides,itemsize,bad", [
    (0x1000, (2048 * 9 * 64, 9 * 64, 64, 1), 2, None),         # prefill q, bf16
    (0x1000, (2048 * 3 * 64, 3 * 64, 64, 1), 2, None),         # prefill k, v
    (0x1002, (2048 * 9 * 64, 9 * 64, 64, 1), 2, "pointer"),    # one element in
    (0x1000, (64 * 4 * 65, 4 * 65, 65, 1), 2, "strides"),      # rows of 65
    (0x1000, (64 * 4 * 68, 4 * 68, 68, 1), 2, "strides"),      # 136 bytes a head
    (0x1000, (64 * 4 * 68, 4 * 68, 68, 1), 4, None),           # 272 bytes a head
], ids=str)
def test_layout_check_needs_16_byte_pointers_and_strides(ptr, strides, itemsize, bad):
    err = _layout.misalignment("q", ptr, strides, itemsize)
    if bad is None:
        assert err is None
    else:
        assert err is not None and bad in err


def test_tensor_core_route_checks_layout_before_it_builds(monkeypatch):
    """On a device tensor the tensor-core route raises on a misaligned
    stride before anything is built or launched, and a failed build of its
    own library raises too (meta tensors stand in for the card's)."""

    def failing_build():
        raise RuntimeError("nvcc failed building flash_attention_sm90")

    monkeypatch.setattr(t_kernel, "library_sm90", failing_build)
    kv = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device="meta")
    bad_q = torch.empty_strided((1, 64, 4, 64), (64 * 4 * 68, 4 * 68, 68, 1),
                                dtype=torch.bfloat16, device="meta")
    before = (t_ops.flash_attention.launches, t_ops.flash_attention.sm90_launches)
    with pytest.raises(ValueError, match="16 bytes"):
        t_ops.flash_attention(bad_q, kv, kv)
    q = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="nvcc failed building flash_attention_sm90"):
        t_ops.flash_attention(q, kv, kv)
    assert (t_ops.flash_attention.launches, t_ops.flash_attention.sm90_launches) == before

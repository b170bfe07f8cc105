"""The port's decode attention (K4) on the CPU against the JAX package's
Pallas kernel in interpret mode, at the shapes of tests/test_kernels.py,
float32 within 2e-5 and bf16 within 3e-2, plus the cases that pin the
port to the kernel rather than to the JAX ``ref.py``: ``count == 0`` gives
zeros (the JAX ref returns the mean of ``v``), ``count == 1`` collapses
onto the first cache row, and the ring-cache validity rule of the model's
decode step, ``count = min(pos + 1, W)``.  The CUDA kernel splits the
window into chunks and merges their partial softmax states: its split plan
is checked here, and ``ref.decode_attention_split``, the same arithmetic in
plain PyTorch, is held to the Pallas kernel at the chunk boundaries.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
checked on a card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import ops as j_ops  # noqa: E402
from repro.kernels.flash_decode import ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_decode import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as t_ref  # noqa: E402
from repro_torch.testing import decode_inputs  # noqa: E402

# (b, w, h, hk, dh, block_k, dtype, counts or None for seeded counts)
CASES = {
    "f32-2x128-h4-g2-d16": (2, 128, 4, 2, 16, 64, "float32", None),
    "f32-4x256-h8-g8-d32": (4, 256, 8, 1, 32, 64, "float32", None),
    "f32-1x512-h4-g1-d64": (1, 512, 4, 4, 64, 64, "float32", None),
    "f32-count-zero": (3, 64, 4, 2, 16, 32, "float32", [0, 5, 64]),
    "f32-count-one": (2, 64, 4, 2, 16, 32, "float32", [1, 1]),
    "f32-ring-filling": (2, 32, 4, 2, 16, 16, "float32", [5 + 1, 20 + 1]),
    "bf16-2x128-h9-g3-d64": (2, 128, 9, 3, 64, 64, "bfloat16", None),
}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _inputs(case):
    b, w, h, hk, dh, _, dtype, counts = CASES[case]
    q, k, v, count = decode_inputs(b, w, h, hk, dh, seed=len(case))
    if counts is not None:
        count = torch.tensor(counts, dtype=torch.int32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return q.to(tdt), k.to(tdt), v.to(tdt), count


def _jax(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


@pytest.fixture(scope="module")
def jax_out():
    """The Pallas kernel (interpret mode) and the JAX ref on every case."""
    out = {}
    for case, (*_, block_k, _dtype, _counts) in CASES.items():
        q, k, v, count = (_jax(x) for x in _inputs(case))
        kern = j_ops.decode_attention(q, k, v, count, block_k=block_k)
        out[case] = (np.asarray(kern, np.float32),
                     np.asarray(j_ref.decode_attention(q, k, v, count), np.float32))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_matches_pallas_kernel(jax_out, case):
    dtype = CASES[case][6]
    q, k, v, count = _inputs(case)
    before = t_ops.decode_attention.launches
    got = t_ops.decode_attention(q, k, v, count)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert t_ops.decode_attention.launches == before  # CPU calls launch nothing
    np.testing.assert_allclose(got.float().numpy(), jax_out[case][0], **TOL[dtype])


def test_count_zero_gives_zeros_as_the_kernel_does(jax_out):
    q, k, v, count = _inputs("f32-count-zero")
    got = t_ops.decode_attention(q, k, v, count)
    kern, jref = jax_out["f32-count-zero"]
    assert (got[0] == 0).all() and (kern[0] == 0).all()
    # The JAX ref.py disagrees there (the mean of v); the port follows the kernel.
    want_mean = v[0].mean(dim=0).repeat_interleave(2, dim=0).numpy()
    np.testing.assert_allclose(jref[0], want_mean, rtol=1e-5, atol=1e-6)


def test_count_one_collapses_onto_the_first_row():
    q, k, v, count = _inputs("f32-count-one")
    got = t_ops.decode_attention(q, k, v, count)
    want = v[:, 0].repeat_interleave(2, dim=1)  # G = 2 heads per KV head
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_reads_a_strided_cache():
    """The engine's cache views are not contiguous; the result must not
    depend on the layout."""
    q, k, v, count = _inputs("f32-2x128-h4-g2-d16")
    k_strided = k.transpose(0, 1).contiguous().transpose(0, 1)
    assert not k_strided.is_contiguous()
    assert torch.equal(t_ops.decode_attention(q, k_strided, v, count),
                       t_ops.decode_attention(q, k, v, count))


def test_rejects_bad_count_and_heads():
    q, k, v, count = _inputs("f32-2x128-h4-g2-d16")
    with pytest.raises(TypeError, match="int32"):
        t_ops.decode_attention(q, k, v, count.long())
    with pytest.raises(ValueError, match="multiple of Hkv"):
        t_ops.decode_attention(q[:, :3], k, v, count)


def test_device_tensor_raises_when_the_build_fails(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: with a
    failing build the wrapper raises instead of running the plain version.
    Meta tensors stand in for the card's here (this machine may have none)."""

    def failing_build():
        raise RuntimeError("nvcc failed building flash_decode")

    monkeypatch.setattr(t_kernel, "library", failing_build)
    q = torch.zeros((2, 4, 16), device="meta")
    kv = torch.zeros((2, 32, 2, 16), device="meta")
    count = torch.zeros((2,), dtype=torch.int32, device="meta")
    before = t_ops.decode_attention.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        t_ops.decode_attention(q, kv, kv, count)
    assert t_ops.decode_attention.launches == before


@pytest.mark.parametrize("window", [1, 63, 64, 65, 128, 512, 4096])
def test_split_plan_covers_the_window(window):
    plan = t_kernel.split_plan(64, 3, window)
    assert plan.splits * plan.chunk >= window > (plan.splits - 1) * plan.chunk
    assert plan.grid == (3, 64, plan.splits)
    assert (plan.splits == 1) == (window <= plan.chunk)


# Counts at the chunk boundaries of a 3-chunk window, one sequence each.
SPLIT_W = 3 * t_kernel.CHUNK
SPLIT_COUNTS = [0, 1, t_kernel.CHUNK - 1, t_kernel.CHUNK, t_kernel.CHUNK + 1, SPLIT_W]


@pytest.fixture(scope="module")
def split_case():
    """Inputs (b = 6, W = 3 chunks, H = 9, Hkv = 3, Dh = 64) and the Pallas
    kernel's output (interpret mode) in float32 and bf16."""
    q, k, v, _ = decode_inputs(len(SPLIT_COUNTS), SPLIT_W, 9, 3, 64, seed=13)
    count = torch.tensor(SPLIT_COUNTS, dtype=torch.int32)
    out = {}
    for name, tdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = (q.to(tdt), k.to(tdt), v.to(tdt), count)
        kern = j_ops.decode_attention(*(_jax(x) for x in args), block_k=64)
        out[name] = (args, np.asarray(kern, np.float32))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_mirror_matches_pallas_kernel_at_chunk_boundaries(split_case, dtype):
    (q, k, v, count), want = split_case[dtype]
    got = t_ref.decode_attention_split(q, k, v, count, t_kernel.CHUNK)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert (got[0] == 0).all()  # count == 0: no chunk is merged
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])

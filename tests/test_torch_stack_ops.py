"""The port's stack ops (K1 ``masked_push``, K2 ``masked_peek``) against the
JAX package's Pallas kernels (interpret mode on the CPU) and plain
versions: bit-exact over dtypes and feature shapes, out-of-range pointers
dropped, the push-then-peek round trip, and the wrappers' refusals.

On the CPU the wrappers run the port's plain versions; the CUDA kernels
themselves are checked on a card by tests/test_torch_cuda.py and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels.stack_ops import ops as j_ops  # noqa: E402
from repro.kernels.stack_ops import ref as j_ref  # noqa: E402
from repro_torch.kernels.stack_ops import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.stack_ops import ops as t_ops  # noqa: E402
from repro_torch.kernels.stack_ops import ref as t_ref  # noqa: E402

D, Z = 6, 9
DTYPES = ("float32", "int32", "bool", "bfloat16", "key")
FEATS = ((), (7,), (3, 5))


def _draw(rng, shape, dtype):
    """The same values for both packages: (jax array, torch tensor)."""
    if dtype == "float32":
        x = (rng.normal(size=shape) * 10).astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x)
    if dtype == "int32":
        x = rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)
        return jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bool":
        x = rng.integers(0, 2, size=shape).astype(bool)
        return jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        x = (rng.normal(size=shape) * 10).astype(np.float32)
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    # PRNG keys: uint32 word pairs in JAX, the same bits as int32 here.
    x = rng.integers(0, 2**32, size=shape + (2,), dtype=np.uint64).astype(np.uint32)
    return jnp.asarray(x), torch.from_numpy(x.view(np.int32).copy())


def _np(x) -> np.ndarray:
    """Comparable numpy bits of either package's result."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _inputs(seed, dtype, feat, lo=0, hi=D):
    rng = np.random.default_rng(seed)
    j_stack, t_stack = _draw(rng, (D, Z) + feat, dtype)
    j_val, t_val = _draw(rng, (Z,) + feat, dtype)
    ptr = rng.integers(lo, hi, Z).astype(np.int32)
    mask = rng.integers(0, 2, Z).astype(bool)
    return (
        (j_stack, jnp.asarray(ptr), j_val, jnp.asarray(mask)),
        (t_stack, torch.from_numpy(ptr), t_val, torch.from_numpy(mask)),
    )


def _assert_same(t_out, j_out, dtype):
    a, b = _np(t_out), _np(j_out)
    if dtype == "key":
        a = a.view(np.uint32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("feat", FEATS)
def test_push_peek_match_pallas_and_ref(dtype, feat):
    (js, jp, jv, jm), (ts, tp, tv, tm) = _inputs(0, dtype, feat)
    j_push = j_ops.masked_push(js, jp, jv, jm)
    _assert_same(t_ops.masked_push(ts.clone(), tp, tv, tm), j_push, dtype)
    _assert_same(t_ref.masked_push(ts, tp, tv, tm), j_ref.masked_push(js, jp, jv, jm), dtype)
    _assert_same(t_ops.masked_peek(ts, tp), j_ops.masked_peek(js, jp), dtype)
    _assert_same(t_ref.masked_peek(ts, tp), j_ref.masked_peek(js, jp), dtype)


@pytest.mark.parametrize("dtype", ["float32", "key"])
def test_out_of_range_and_negative_pointers_dropped(dtype):
    (js, jp, jv, jm), (ts, tp, tv, tm) = _inputs(1, dtype, (), lo=-3, hi=D + 3)
    jm = jnp.ones_like(jm)
    tm = torch.ones_like(tm)
    out = t_ops.masked_push(ts.clone(), tp, tv, tm)
    _assert_same(out, j_ops.masked_push(js, jp, jv, jm), dtype)
    dropped = (tp < 0) | (tp >= D)
    assert dropped.any()
    assert torch.equal(out[:, dropped], ts[:, dropped])
    _assert_same(t_ops.masked_peek(ts, tp), j_ops.masked_peek(js, jp), dtype)


def test_push_writes_in_place_and_counts_no_cpu_launch():
    _, (ts, tp, tv, tm) = _inputs(2, "float32", (7,))
    before = (t_ops.masked_push.launches, t_ops.masked_peek.launches)
    stack = ts.clone()
    out = t_ops.masked_push(stack, tp, tv, tm)
    assert out is stack
    assert torch.equal(stack, t_ref.masked_push(ts, tp, tv, tm))
    t_ops.masked_peek(stack, tp)
    assert (t_ops.masked_push.launches, t_ops.masked_peek.launches) == before


@settings(max_examples=25, deadline=None)
@given(
    d=st.integers(1, 8),
    z=st.integers(1, 12),
    f=st.integers(1, 9),
    seed=st.integers(0, 2**16),
)
def test_property_push_then_peek_roundtrip(d, z, f, seed):
    """For active lanes, peek(push(stack, ptr, v), ptr) == v; inactive
    lanes and untouched depths are unchanged — the VM's invariant."""
    rng = np.random.default_rng(seed)
    stack = torch.from_numpy(rng.normal(size=(d, z, f)).astype(np.float32))
    val = torch.from_numpy(rng.normal(size=(z, f)).astype(np.float32))
    ptr = torch.from_numpy(rng.integers(0, d, z).astype(np.int32))
    mask = torch.from_numpy(rng.integers(0, 2, z).astype(bool))
    pushed = t_ops.masked_push(stack.clone(), ptr, val, mask)
    peeked = t_ops.masked_peek(pushed, ptr)
    assert torch.equal(peeked[mask], val[mask])
    assert torch.equal(peeked[~mask], t_ref.masked_peek(stack, ptr)[~mask])
    for lane in range(z):
        rows = torch.ones(d, dtype=torch.bool)
        if mask[lane]:
            rows[int(ptr[lane])] = False
        assert torch.equal(pushed[rows, lane], stack[rows, lane])


def test_rejects_non_contiguous_stack():
    _, (ts, tp, tv, tm) = _inputs(3, "float32", (7,))
    strided = ts.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.masked_push(strided, tp, tv, tm)
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.masked_peek(strided, tp)


def test_rejects_int64_pointers_and_non_bool_mask():
    _, (ts, tp, tv, tm) = _inputs(4, "float32", ())
    with pytest.raises(TypeError, match="int32"):
        t_ops.masked_push(ts, tp.long(), tv, tm)
    with pytest.raises(TypeError, match="int32"):
        t_ops.masked_peek(ts, tp.long())
    with pytest.raises(TypeError, match="bool"):
        t_ops.masked_push(ts, tp, tv, tm.to(torch.int32))


def test_device_tensor_raises_when_the_build_fails(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: with a
    failing build the wrapper raises instead of running the plain version.
    Meta tensors stand in for the card's here (this machine may have none)."""

    def failing_build():
        raise RuntimeError("nvcc failed building stack_ops")

    monkeypatch.setattr(t_kernel, "library", failing_build)
    stack = torch.zeros((D, Z, 2), device="meta")
    ptr = torch.zeros((Z,), dtype=torch.int32, device="meta")
    val = torch.zeros((Z, 2), device="meta")
    mask = torch.zeros((Z,), dtype=torch.bool, device="meta")
    before = (t_ops.masked_push.launches, t_ops.masked_peek.launches)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        t_ops.masked_push(stack, ptr, val, mask)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        t_ops.masked_peek(stack, ptr)
    assert (t_ops.masked_push.launches, t_ops.masked_peek.launches) == before


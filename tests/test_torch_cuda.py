"""Tests of the port that need the card: the hand-written CUDA stack
kernels against their plain versions, and the VM and NUTS on CUDA against
the same port on the CPU.  They skip where there is no CUDA device; on the
card run them with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.

This file imports no JAX (the card's machine has none): it compares the
port with itself across devices, and the CPU side is held to the JAX
package by the other tests/test_torch_*.py files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import batching  # noqa: E402
from repro_torch.kernels.stack_ops import ops, ref  # noqa: E402
from repro_torch.mcmc import nuts, targets  # noqa: E402
from repro_torch.testing import build_fib, build_mutual  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _stack_inputs(dtype, feat, seed=5, d=6, z=9):
    rng = np.random.default_rng(seed)
    shape = (d, z) + feat
    if dtype == torch.bool:
        stack, val = (torch.from_numpy(rng.integers(0, 2, s).astype(bool))
                      for s in (shape, shape[1:]))
    elif dtype == torch.int32:
        stack, val = (torch.from_numpy(rng.integers(-2**31, 2**31 - 1, s).astype(np.int32))
                      for s in (shape, shape[1:]))
    else:
        stack, val = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
                      for s in (shape, shape[1:]))
    ptr = torch.from_numpy(rng.integers(-2, d + 2, z).astype(np.int32))
    mask = torch.from_numpy(rng.integers(0, 2, z).astype(bool))
    return stack, ptr, val, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bool, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("feat", [(), (7,), (3, 5), (2,)], ids=str)
def test_kernels_match_plain_versions(cuda, dtype, feat):
    stack, ptr, val, mask = (x.to(cuda) for x in _stack_inputs(dtype, feat))
    pushes, peeks = ops.masked_push.launches, ops.masked_peek.launches
    got = ops.masked_push(stack.clone(), ptr, val, mask)
    got_peek = ops.masked_peek(stack, ptr)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.masked_push(stack, ptr, val, mask))
    assert torch.equal(got_peek, ref.masked_peek(stack, ptr))
    assert (ops.masked_push.launches, ops.masked_peek.launches) == (pushes + 1, peeks + 1)


@pytest.mark.parametrize("build,hi", [(build_fib, 11), (build_mutual, 20)], ids=["fib", "mutual"])
def test_vm_on_cuda_matches_cpu_through_the_kernels(cuda, build, hi):
    n = torch.from_numpy(np.random.default_rng(0).integers(0, hi, 9).astype(np.int32))
    cpu_fn = batching.autobatch(build(), max_depth=24, device="cpu")
    gpu_fn = batching.autobatch(build(), max_depth=24, device=cuda)
    want = cpu_fn(n)["out"]
    ops.masked_push.launches = ops.masked_peek.launches = 0
    got = gpu_fn(n.to(cuda))["out"]
    assert torch.equal(got.cpu(), want)
    assert ops.masked_push.launches > 0 and ops.masked_peek.launches > 0
    cpu_res, gpu_res = cpu_fn.last_result, gpu_fn.last_result
    assert gpu_res.steps == cpu_res.steps
    np.testing.assert_array_equal(gpu_res.block_exec, cpu_res.block_exec)
    np.testing.assert_array_equal(gpu_res.block_active, cpu_res.block_active)
    assert torch.equal(gpu_res.lane_steps.cpu(), cpu_res.lane_steps)


def test_nuts_on_cuda_matches_cpu(cuda):
    """Same control flow chain by chain; samples to 1e-4 (reductions sum in
    another order on the card)."""
    settings = nuts.NutsSettings(max_tree_depth=5, num_steps=3, steps_per_leaf=2)
    runs = {}
    for dev in ("cpu", cuda):
        target = targets.logistic_regression(200, 8, device=dev)
        kern = nuts.make_nuts_kernel(target, settings, device=dev)
        out = kern(*nuts.initial_state(target, 4, eps=0.05, seed=5, device=dev))
        runs[str(dev)] = (out["theta"].cpu(), kern.last_result)
    (th_h, res_h), (th_c, res_c) = runs["cpu"], runs[str(cuda)]
    assert res_c.converged and res_h.converged
    assert torch.equal(res_c.lane_steps.cpu(), res_h.lane_steps)
    assert res_c.tag_stats == res_h.tag_stats
    torch.testing.assert_close(th_c, th_h, rtol=1e-4, atol=1e-5)

"""Tests of the port that need the card: the hand-written CUDA kernels
(stack ops K1/K2, flash attention K3, decode attention K4) against their
plain versions, a failed build raising, and the VM (every schedule, lane
compaction), local static batching from CUDA graphs, NUTS (pc and
iterative), the serving engine and the MoE, xLSTM and Zamba2 models on
CUDA against the same port on the CPU, its eager mode or its own oracle; segmented runs and quarantined faults on
the card against one run and the CPU, and open-loop serving against its
oracle; traced and profile-guided NUTS bit-exact with the plain run on the
card, and the engine's program verified there (fake typing, K3/K4 through
their shape rule); a train step on the card against the same step on the
CPU, a checkpoint written on the card and read on the CPU, and K3/K4
refusing autograd on the card.  They skip where there is no CUDA device; on the
card run them with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.

This file imports no JAX (the card's machine has none): it compares the
port with itself across devices, and the CPU side is held to the JAX
package by the other tests/test_torch_*.py files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import batching, ir  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as fd_kernel  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as fd_ref  # noqa: E402
from repro_torch.kernels.stack_ops import kernel as sk_kernel  # noqa: E402
from repro_torch.kernels.stack_ops import ops, ref  # noqa: E402
from repro_torch.mcmc import iterative, nuts, targets  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve.engine import EngineConfig, GenerationEngine, Request  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    attention_inputs, build_fib, build_mutual, decode_inputs, engine_inputs,
    stack_group_inputs, to_torch,
)
from repro_torch.train.fault_tolerance import reshard  # noqa: E402

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


GROUP_DTYPES = (torch.float32, torch.int32, torch.bool, torch.bfloat16)
GROUP_SHAPES = ((), (2,), (100,), (3, 5), (7,))


def _group(specs, lanes, seed, device, mask="random"):
    """Seeded push entries ``(stack, ptr, top, src)`` and a mask on ``device``."""
    np_entries, np_mask = stack_group_inputs(specs, lanes, seed, mask)
    entries = [(to_torch(st, s.dtype, device), torch.from_numpy(p).to(device),
                to_torch(t, s.dtype, device), to_torch(src, s.dtype, device))
               for (st, p, t, src), s in zip(np_entries, specs)]
    return entries, torch.from_numpy(np_mask).to(device)


def _check_group(specs, entries, mask, lanes, max_depth=4):
    """Push and pop groups against ref.push_group / pop_group on clones of
    the same tensors, bit for bit; one launch per 16 entries of each."""
    per = -(-len(specs) // sk_kernel.MAX_ENTRIES)
    has_src = [e[3] is not None for e in entries]
    clone = [(st.clone(), p, t, src) for st, p, t, src in entries]
    flags = torch.zeros(lanes, dtype=torch.bool, device=mask.device)
    want_flags = flags.clone()
    pushes, peeks = ops.masked_push.launches, ops.masked_peek.launches
    got = ops.PushGroup(specs, has_src, lanes)(entries, mask, flags, max_depth)
    want = ref.push_group(clone, mask, want_flags, max_depth)
    pops = ops.PopGroup(specs, lanes)([(st, p, t) for st, p, t, _ in clone], mask)
    want_pops = ref.pop_group([(st, p, t) for st, p, t, _ in clone], mask)
    torch.cuda.synchronize()
    assert (ops.masked_push.launches, ops.masked_peek.launches) == (pushes + per, peeks + per)
    assert torch.equal(flags, want_flags)
    for i in range(len(specs)):
        assert torch.equal(entries[i][0], clone[i][0]), f"stack {i} ({specs[i]})"
        assert torch.equal(got[0][i], want[0][i]), f"new ptr {i}"
        if has_src[i]:
            assert torch.equal(got[1][i], want[1][i]), f"new top {i} ({specs[i]})"
        else:
            assert got[1][i] is None
        assert torch.equal(pops[0][i], want_pops[0][i]), f"pop ptr {i}"
        assert torch.equal(pops[1][i], want_pops[1][i]), f"pop top {i} ({specs[i]})"


@pytest.mark.parametrize("mask", ["random", "on", "off"])
@pytest.mark.parametrize("n", [1, 13, 17])
def test_group_kernels_match_plain_versions(cuda, n, mask):
    """Random groups of 1, 13 and 17 entries (17 takes two launches) over
    every dtype and row shape, pointers out of range and negative."""
    specs = [ops.StackSpec(6, GROUP_SHAPES[i % 5], GROUP_DTYPES[i % 4]) for i in range(n)]
    entries, m = _group(specs, 300, seed=n, device=cuda, mask=mask)
    _check_group(specs, entries, m, 300)


def _offset(x, by):
    """``x``'s values in a tensor of the same layout that starts ``by``
    elements into its storage (a base aligned to fewer bytes)."""
    buf = torch.empty(x.numel() + by, dtype=x.dtype, device=x.device)
    out = buf[by:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (100,)),   # 400 B rows: 16-byte accesses
    (torch.int32, (2,)),       # 8 B: the PRNG keys
    (torch.float32, ()),       # 4 B
    (torch.float32, (3,)),     # 12 B: 4-byte accesses
    (torch.bfloat16, ()),      # 2 B
    (torch.bfloat16, (3,)),    # 6 B: 2-byte accesses
    (torch.bool, ()),          # 1 B
    (torch.bool, (3,)),        # 3 B: 1-byte accesses
], ids=str)
@pytest.mark.parametrize("moved", ["aligned", "stack", "top", "src"])
def test_group_kernels_every_alignment_class(cuda, dtype, shape, moved):
    """Each row size, and each operand moved one element off its aligned
    base, which narrows the accesses (down to the element size)."""
    specs = [ops.StackSpec(5, shape, dtype)]
    entries, m = _group(specs, 130, seed=7, device=cuda)
    st, p, t, src = entries[0]
    if moved != "aligned":
        st, t, src = (_offset(x, 1) if moved == name else x
                      for x, name in ((st, "stack"), (t, "top"), (src, "src")))
    _check_group(specs, [(st, p, t, src)], m, 130)


@pytest.mark.parametrize("dtype,shape", [(torch.float32, (100,)), (torch.bool, ()),
                                         (torch.int32, (2,))], ids=str)
def test_group_kernels_take_a_broadcast_src(cuda, dtype, shape):
    """A constant src with a lane stride of 0, as the VM broadcasts its
    constants, beside an ordinary entry; and a pc-like entry with no src."""
    specs = [ops.StackSpec(5, shape, dtype)] * 2 + [ops.StackSpec(5, (), torch.int32)]
    entries, m = _group(specs, 200, seed=8, device=cuda)
    const = entries[0][3][:1].expand(entries[0][3].shape)
    assert const.stride()[0] == 0
    entries[0] = entries[0][:3] + (const,)
    entries[2] = entries[2][:3] + (None,)
    _check_group(specs, entries, m, 200)


def _launches_per_dispatch(vm, kind):
    return [sum(-(-len(g) // sk_kernel.MAX_ENTRIES) for g in groups if g.kind == kind)
            for groups in vm.stack_groups]


@pytest.mark.parametrize("build,hi", [(build_fib, 11), (build_mutual, 20)], ids=["fib", "mutual"])
def test_vm_launches_one_kernel_per_stack_group(cuda, build, hi):
    """K1/K2 launches in a VM run equal the dispatches of each block times
    its push (pop) groups: none per op, none outside a group."""
    n = torch.from_numpy(np.random.default_rng(1).integers(0, hi, 9).astype(np.int32))
    fn = batching.autobatch(build(), max_depth=24, device=cuda)
    fn(n.to(cuda))
    ops.masked_push.launches = ops.masked_peek.launches = 0
    fn(n.to(cuda))
    vm, be = fn._last_executor.vm, fn.last_result.block_exec
    want = [int(np.dot(be, _launches_per_dispatch(vm, k))) for k in ("push", "pop")]
    assert [ops.masked_push.launches, ops.masked_peek.launches] == want
    assert all(want)


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


@pytest.mark.parametrize("compact_every", [None, 1, 3], ids=lambda c: f"ce{c}")
@pytest.mark.parametrize("schedule", ["earliest", "popular", "lookahead", "sweep"])
@pytest.mark.parametrize("build,hi", [(build_fib, 11), (build_mutual, 20)], ids=["fib", "mutual"])
def test_schedules_on_cuda_match_cpu(cuda, build, hi, schedule, compact_every):
    """Every schedule, with and without lane compaction, is bit-exact with
    the port on the CPU: outputs, counters, per-lane steps, occupancy."""
    n = torch.from_numpy(np.random.default_rng(2).integers(0, hi, 13).astype(np.int32))
    knobs = dict(max_depth=24, schedule=schedule, compact_every=compact_every)
    cpu_fn = batching.autobatch(build(), device="cpu", **knobs)
    gpu_fn = batching.autobatch(build(), device=cuda, **knobs)
    assert torch.equal(gpu_fn(n.to(cuda))["out"].cpu(), cpu_fn(n)["out"])
    cpu_res, gpu_res = cpu_fn.last_result, gpu_fn.last_result
    assert gpu_res.steps == cpu_res.steps
    np.testing.assert_array_equal(gpu_res.block_exec, cpu_res.block_exec)
    np.testing.assert_array_equal(gpu_res.block_active, cpu_res.block_active)
    assert torch.equal(gpu_res.lane_steps.cpu(), cpu_res.lane_steps)
    assert gpu_res.sched == cpu_res.sched


@pytest.mark.parametrize("build,hi", [(build_fib, 11), (build_mutual, 20)], ids=["fib", "mutual"])
def test_sweep_launches_every_group_of_every_block(cuda, build, hi):
    """A sweep runs every block each iteration, so K1/K2 launch iterations
    x the push (pop) groups of all blocks, residents or not."""
    n = torch.from_numpy(np.random.default_rng(1).integers(0, hi, 9).astype(np.int32))
    fn = batching.autobatch(build(), max_depth=24, schedule="sweep", device=cuda)
    fn(n.to(cuda))
    ops.masked_push.launches = ops.masked_peek.launches = 0
    fn(n.to(cuda))
    vm, steps = fn._last_executor.vm, fn.last_result.steps
    want = [steps * sum(_launches_per_dispatch(vm, k)) for k in ("push", "pop")]
    assert [ops.masked_push.launches, ops.masked_peek.launches] == want
    assert all(want)


def test_nuts_schedules_and_compaction_on_cuda(cuda):
    """NUTS samples identical chains under every schedule and with lane
    compaction on the card."""
    settings = nuts.NutsSettings(max_tree_depth=5, num_steps=3, steps_per_leaf=2)
    target = targets.logistic_regression(200, 8, device=cuda)
    args = nuts.initial_state(target, 16, eps=0.05, seed=5, device=cuda)
    want = nuts.make_nuts_kernel(target, settings, device=cuda)(*args)
    for schedule in ("earliest", "popular", "lookahead", "sweep"):
        for ce in (None, 1):
            kern = nuts.make_nuts_kernel(target, settings, schedule=schedule,
                                         compact_every=ce, device=cuda)
            got = kern(*args)
            for k, v in want.items():
                assert torch.equal(got[k], v), (schedule, ce, k)


def test_local_graph_segments_equal_eager(cuda):
    """``local`` replays each segment from a CUDA graph; it computes what
    ``local_eager`` computes, bit for bit, with the same counters."""
    settings = nuts.NutsSettings(max_tree_depth=5, num_steps=3, steps_per_leaf=2)
    target = targets.logistic_regression(200, 8, device=cuda)
    args = nuts.initial_state(target, 16, eps=0.05, seed=5, device=cuda)
    runs = {}
    for backend in ("local", "local_eager", "pc"):
        kern = nuts.make_nuts_kernel(target, settings, backend=backend, device=cuda)
        kern(*args)  # the first call captures the graphs
        runs[backend] = (kern(*args), kern.tag_stats)
    (out, tags), (out_e, tags_e) = runs["local"], runs["local_eager"]
    assert tags == tags_e
    for k in out:
        assert torch.equal(out[k], out_e[k]), k
    assert runs["pc"][1]["grad"][1] == tags["grad"][1]
    fn = batching.autobatch(build_fib(), backend="local", device=cuda)
    n = torch.arange(12, dtype=torch.int32)
    assert torch.equal(fn(n.to(cuda))["out"].cpu(),
                       batching.autobatch(build_fib(), backend="local_eager",
                                          device=cuda)(n.to(cuda))["out"].cpu())


def test_reference_interpreter_runs_on_cuda(cuda):
    """The unbatched interpreter runs on the device of its inputs; the
    program's constants (made on the host) are moved there."""
    settings = nuts.NutsSettings(max_tree_depth=4, num_steps=2, steps_per_leaf=2)
    outs = {}
    for dev in ("cpu", cuda):
        target = targets.logistic_regression(200, 8, device=dev)
        kern = nuts.make_nuts_kernel(target, settings, backend="reference", device=dev)
        outs[str(dev)] = kern(*nuts.initial_state(target, 2, eps=0.05, seed=5, device=dev))
    for k, v in outs["cpu"].items():
        assert outs[str(cuda)][k].device.type == "cuda"
        torch.testing.assert_close(outs[str(cuda)][k].cpu(), v, rtol=1e-4, atol=1e-5)


def test_iterative_on_cuda_matches_cpu(cuda):
    settings = nuts.NutsSettings(max_tree_depth=5, num_steps=3, steps_per_leaf=2)
    outs = {}
    for dev in ("cpu", cuda):
        target = targets.logistic_regression(200, 8, device=dev)
        run = iterative.make_batched(target, settings, device=dev)
        outs[str(dev)] = run(*nuts.initial_state(target, 8, eps=0.05, seed=5, device=dev))
    got, want = outs[str(cuda)], outs["cpu"]
    assert torch.equal(got["grads"].cpu(), want["grads"])
    torch.testing.assert_close(got["theta"].cpu(), want["theta"], rtol=1e-4, atol=1e-5)


# Float32: the kernel and the plain version sum in another order.  bf16:
# both compute in float32 and round once, so they differ by at most about
# one bf16 ulp of the output (2**-8 relative).
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,s,t,h,hk,dh,causal", [
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 8, 32, True),
    (2, 32, 32, 4, 1, 16, True),
    (1, 192, 192, 2, 2, 128, True),
    (2, 64, 128, 4, 2, 64, False),
    (2, 128, 128, 4, 2, 112, True),   # Zamba2-7B's head dim
    (1, 192, 192, 4, 4, 80, True),    # HuBERT-XLarge's head dim
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, t, h, hk, dh, causal):
    q, k, v = (x.to(cuda, dtype) for x in attention_inputs(b, s, t, h, hk, dh, seed=1))
    before, before_sm90 = fa_ops.flash_attention.launches, fa_ops.flash_attention.sm90_launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    on_sm90 = fa_kernel.route(dtype, dh) == "sm90"
    assert fa_ops.flash_attention.sm90_launches == before_sm90 + on_sm90
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), fa_ref.attention(q, k, v, causal=causal).float(),
                               **TOL[dtype])


def test_flash_attention_reads_strided_heads(cuda):
    """k and v as head slices of one wider tensor: read through strides."""
    q, k, v = (x.to(cuda) for x in attention_inputs(2, 64, 64, 4, 2, 32, seed=2))
    kv = torch.cat([k, v], dim=2)  # [B, T, 2*Hkv, Dh]
    k_view, v_view = kv[:, :, :2], kv[:, :, 2:]
    assert not k_view.is_contiguous()
    got = fa_ops.flash_attention(q, k_view, v_view)
    torch.testing.assert_close(got, fa_ref.attention(q, k, v), **TOL[torch.float32])


@pytest.mark.parametrize("b,s,t,h,hk,dh,causal", [
    (1, 128, 128, 1, 1, 64, False),   # one CTA, G = 1
    (2, 192, 192, 4, 2, 64, True),    # a 64-row remainder tile
    (1, 256, 256, 8, 8, 128, True),   # Dh = 128 (two TMA boxes), G = 1
    (2, 128, 256, 9, 3, 64, False),   # S != T, G = 3 (SmolLM-135M's heads)
    (1, 384, 384, 8, 1, 64, True),    # G = 8, three key tiles
    (1, 320, 320, 6, 2, 128, True),   # Dh = 128 with a remainder tile
], ids=str)
def test_flash_attention_sm90_matches_plain(cuda, b, s, t, h, hk, dh, causal):
    """bf16 with Dh 64 or 128 goes through the TMA + wgmma kernel, within
    the bf16 tolerance of the plain version."""
    assert fa_kernel.route(torch.bfloat16, dh) == "sm90"
    q, k, v = (x.to(cuda, torch.bfloat16) for x in attention_inputs(b, s, t, h, hk, dh, seed=6))
    before, before_sm90 = fa_ops.flash_attention.launches, fa_ops.flash_attention.sm90_launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.sm90_launches == before_sm90 + 1
    assert fa_ops.flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), fa_ref.attention(q, k, v, causal=causal).float(),
                               **TOL[torch.bfloat16])


def test_misaligned_operands_raise(cuda):
    """TMA and 16-byte loads need aligned pointers and strides: a view one
    element into a wider tensor raises instead of launching."""
    q, k, v = (x.to(cuda, torch.bfloat16) for x in attention_inputs(1, 64, 64, 4, 2, 64))
    wide = torch.zeros((1, 64, 4, 65), dtype=torch.bfloat16, device=cuda)
    before = fa_ops.flash_attention.launches
    with pytest.raises(ValueError, match="16"):
        fa_ops.flash_attention(wide[..., 1:], k, v)
    assert fa_ops.flash_attention.launches == before
    dq, dk, dv, count = (x.to(cuda) for x in decode_inputs(2, 64, 4, 2, 64))
    wide = torch.zeros((2, 64, 2, 65), device=cuda)
    before = fd_ops.decode_attention.launches
    with pytest.raises(ValueError, match="16"):
        fd_ops.decode_attention(dq, wide[..., 1:], dv, count)
    assert fd_ops.decode_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,hk", [(6, 3), (48, 3)], ids=["18-ctas-a-split", "144-ctas-a-split"])
def test_decode_attention_splits_at_chunk_boundaries(cuda, dtype, b, hk):
    """Counts 0, 1, chunk - 1, chunk, chunk + 1 and W on the lane-first view
    the serving VM hands over, with B x Hkv under and over the card's 132
    SMs: zeros for an empty cache, the plain version elsewhere."""
    w, g, dh = 192, 3, 64
    chunk = fd_kernel.split_plan(b, hk, w).chunk
    q, k, v, _ = decode_inputs(b, w, hk * g, hk, dh, seed=9)
    counts = [0, 1, chunk - 1, chunk, chunk + 1, w]
    count = torch.tensor([counts[i % len(counts)] for i in range(b)], dtype=torch.int32)
    q, k, v, count = q.to(cuda, dtype), k.to(cuda, dtype), v.to(cuda, dtype), count.to(cuda)
    lane_first = torch.stack([k + 1, k]).movedim(1, 0).contiguous().movedim(0, 1)
    k_view = lane_first[1]  # [B, W, Hkv, Dh], batch stride 2 * W * Hkv * Dh
    assert not k_view.is_contiguous()
    before = fd_ops.decode_attention.launches
    got = fd_ops.decode_attention(q, k_view, v, count)
    torch.cuda.synchronize()
    assert fd_ops.decode_attention.launches == before + 1
    empty = count == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    torch.testing.assert_close(got.float(), fd_ref.decode_attention(q, k, v, count).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,w,h,hk,dh", [
    (2, 128, 4, 2, 16), (4, 256, 8, 1, 32), (3, 512, 9, 3, 64), (2, 96, 4, 2, 128),
    (2, 256, 8, 4, 112),   # Zamba2-7B's head dim
    (3, 192, 4, 2, 80),    # HuBERT-XLarge's head dim
    (2, 128, 16, 1, 64),   # 16 query heads per KV head (Qwen3-MoE-235B-A22B's group)
    (2, 200, 32, 2, 128),  # the same group at Dh 128, with a partial last chunk
    (2, 96, 16, 1, 112),   # the largest group at Dh 112
])
def test_decode_attention_kernel_matches_plain(cuda, dtype, b, w, h, hk, dh):
    q, k, v, count = decode_inputs(b, w, h, hk, dh, seed=3)
    count[0] = 0  # an empty cache gives zeros
    count[-1] = w
    q, k, v = (x.to(cuda, dtype) for x in (q, k, v))
    count = count.to(cuda)
    before = fd_ops.decode_attention.launches
    got = fd_ops.decode_attention(q, k, v, count)
    torch.cuda.synchronize()
    assert fd_ops.decode_attention.launches == before + 1
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got.float(), fd_ref.decode_attention(q, k, v, count).float(),
                               **TOL[dtype])


def test_decode_attention_reads_the_cache_where_it_lies(cuda):
    """The serving VM hands the cache over lane-first and moves it back as
    a view whose batch axis is not outermost; K4 reads it without a copy."""
    q, k, v, count = (x.to(cuda) for x in decode_inputs(3, 64, 4, 2, 32, seed=4))
    layers_first = torch.stack([k, k + 1])  # [L, B, W, Hkv, Dh]
    lane_first = layers_first.movedim(1, 0).contiguous().movedim(0, 1)
    k_view = lane_first[1]
    assert not k_view.is_contiguous()
    got = fd_ops.decode_attention(q, k_view, v, count)
    torch.testing.assert_close(got, fd_ref.decode_attention(q, k + 1, v, count),
                               **TOL[torch.float32])


def _flash_call(x):
    return fa_ops.flash_attention(x, x[:, :, :2], x[:, :, :2])


def _decode_call(x):
    count = torch.ones(x.shape[0], dtype=torch.int32, device=x.device)
    return fd_ops.decode_attention(x[:, 0].contiguous(), x[:, :, :2], x[:, :, :2], count)


def _flash_sm90_call(x):
    x = x.to(torch.bfloat16).repeat(1, 1, 1, 4)  # Dh = 64: the tensor-core kernel
    return fa_ops.flash_attention(x, x[:, :, :2], x[:, :, :2])


def _push_group_call(x):
    stack = x.reshape(4, 2, 64, 16).transpose(0, 1).contiguous()  # [D=2, Z=4, ...]
    ptr = torch.zeros(4, dtype=torch.int32, device=x.device)
    mask = torch.ones(4, dtype=torch.bool, device=x.device)
    return ops.push_group([(stack, ptr, stack[0], stack[1])], mask,
                          torch.zeros_like(mask), 2)


def _pop_group_call(x):
    stack = x.reshape(4, 2, 64, 16).transpose(0, 1).contiguous()
    mask = torch.ones(4, dtype=torch.bool, device=x.device)
    return ops.pop_group([(stack, torch.ones(4, dtype=torch.int32, device=x.device),
                           stack[0])], mask)


@pytest.mark.parametrize("library,counter,call", [
    (fa_kernel.library, fa_ops.flash_attention, _flash_call),
    (fa_kernel.library_sm90, fa_ops.flash_attention, _flash_sm90_call),
    (fd_kernel.library, fd_ops.decode_attention, _decode_call),
    (sk_kernel.library, ops.masked_push, _push_group_call),
    (sk_kernel.library, ops.masked_peek, _pop_group_call),
], ids=["flash_attention", "flash_attention_sm90", "flash_decode", "push_group",
        "pop_group"])
def test_failed_build_raises(cuda, monkeypatch, library, counter, call):
    """A real nvcc failure (an unknown flag) raises from the wrapper; nothing
    runs the plain version instead, and no launch is counted."""
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("--no-such-flag",))
    library.cache_clear()
    x = torch.zeros((2, 64, 4, 16), device=cuda)
    before = counter.launches
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call(x)
    finally:
        library.cache_clear()
    assert counter.launches == before


FAMILY_ARCHS = ["deepseek-moe-16b", "xlstm-350m", "zamba2-7b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_and_decode_on_cuda_match_cpu(cuda, arch):
    """Float32 smoke configs of the MoE, xLSTM and Zamba2 families: the
    same weights on the card and on the CPU give the same logits (forward,
    and 6 decode steps through K4), within 1e-4: float32 sums in another
    order on each device, through every layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke_config(arch)
    cpu = get_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    dev = get_model(cfg, device=cuda)
    dparams = reshard(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    want, _ = cpu.forward(params, {"tokens": tokens})
    got, _ = dev.forward(dparams, {"tokens": tokens.to(cuda)})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    cache, dcache = cpu.init_cache(2, 8), dev.init_cache(2, 8)
    before = fd_ops.decode_attention.launches
    for step in range(6):
        tok, pos = tokens[:, step], torch.full((2,), step, dtype=torch.int32)
        want, cache = cpu.decode_step(params, cache, tok, pos)
        got, dcache = dev.decode_step(dparams, dcache, tok.to(cuda), pos.to(cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert fd_ops.decode_attention.launches == before + 6 * dev.attention_sites


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_engines_on_cuda_match_their_oracle(cuda, arch):
    """The MoE, xLSTM and Zamba2 smoke configs served on the card, 4 lanes
    x 2 requests: the sequential oracle's tokens, with K4 launched once per
    attention site of every decode execution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke_config(arch)
    model = get_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    ecfg = EngineConfig(lanes=4, max_context=16, max_prompt_len=6, max_new_tokens=6,
                        requests_per_lane=2, eos_id=0)
    eng = GenerationEngine(model, params, ecfg)
    prompts, plens = engine_inputs(ecfg, cfg.vocab_size, seed=0)
    eng.batched.lowered
    fd_ops.decode_attention.launches = 0
    res = eng.generate(prompts, plens)
    execs = eng.batched.tag_stats["decode"][0]
    assert fd_ops.decode_attention.launches == model.attention_sites * execs
    ref_out = eng.reference_generate(prompts, plens)
    np.testing.assert_array_equal(res["tokens"], ref_out["tokens"])
    np.testing.assert_array_equal(res["lengths"], ref_out["lengths"])


def test_engine_on_cuda_matches_its_oracle(cuda):
    """Float32 smoke SmolLM, 4 lanes x 2 requests: the batched engine on the
    card gives its sequential oracle's tokens, through K4 on every layer
    of every decode execution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke_config("smollm-135m")
    model = get_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    ecfg = EngineConfig(lanes=4, max_context=32, max_prompt_len=6, max_new_tokens=8,
                        requests_per_lane=2, eos_id=0)
    eng = GenerationEngine(model, params, ecfg)
    prompts, plens = engine_inputs(ecfg, cfg.vocab_size, seed=0)
    eng.batched.lowered  # type inference types the decode prim on fake tensors
    fd_ops.decode_attention.launches = 0
    res = eng.generate(prompts, plens)
    execs = eng.batched.tag_stats["decode"][0]
    assert fd_ops.decode_attention.launches == cfg.num_layers * execs
    ref_out = eng.reference_generate(prompts, plens)
    np.testing.assert_array_equal(res["tokens"], ref_out["tokens"])
    np.testing.assert_array_equal(res["lengths"], ref_out["lengths"])


@pytest.mark.parametrize("compact_every", [None, 1], ids=lambda c: f"ce{c}")
@pytest.mark.parametrize("schedule", ["earliest", "popular", "lookahead", "sweep"])
def test_segments_on_cuda_match_one_run(cuda, schedule, compact_every):
    """A chain of 3-iteration segments on the card equals one run on the
    card — outputs, counters, per-lane steps and fault codes, and the K1/K2
    launches — and the segmented run on the CPU."""
    n = torch.from_numpy(np.random.default_rng(3).integers(0, 11, 13).astype(np.int32))
    knobs = dict(max_depth=24, schedule=schedule, compact_every=compact_every)
    fn = batching.autobatch(build_fib(), device=cuda, **knobs)
    ops.masked_push.launches = ops.masked_peek.launches = 0
    want = fn(n.to(cuda))["out"]
    one = (ops.masked_push.launches, ops.masked_peek.launches)
    res = fn.last_result
    outs = {}
    for dev in (cuda, "cpu"):
        f = fn if dev == cuda else batching.autobatch(build_fib(), device="cpu", **knobs)
        st = f.stepper(n.to(dev))
        state = st.init()
        ops.masked_push.launches = ops.masked_peek.launches = 0
        while not st.done(state):
            state = st.step(state, 3)
        if dev == cuda:
            assert (ops.masked_push.launches, ops.masked_peek.launches) == one
        outs[str(dev)] = (st.result(state)["out"].cpu(), st.vm.result(state))
    got, seg = outs[str(cuda)]
    assert torch.equal(got, want.cpu()) and torch.equal(outs["cpu"][0], got)
    for r in (seg, outs["cpu"][1]):
        assert r.steps == res.steps and r.sched == res.sched
        np.testing.assert_array_equal(r.block_exec, res.block_exec)
        assert torch.equal(r.lane_steps.cpu(), res.lane_steps.cpu())
        assert torch.equal(r.fault_code.cpu(), res.fault_code.cpu())


@pytest.mark.parametrize("schedule", ["earliest", "lookahead", "sweep"])
def test_quarantine_on_cuda_matches_cpu(cuda, schedule):
    """The chaos program (NaN, livelock and overflow lanes beside healthy
    ones) under quarantine: codes, outputs, dispatches and counters on the
    card equal the CPU's, and the healthy lanes equal a fault-free run."""
    from tools import torch_chaos

    modes = torch_chaos.make_modes(16, 0.25, seed=1)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 10_000, 16).astype(np.int32))
    runs = {}
    for dev in (cuda, "cpu"):
        fn = torch_chaos.chaos_fn(device=dev, schedule=schedule)
        clean = fn(x.to(dev), torch.zeros(16, dtype=torch.int32, device=dev))["out"].cpu()
        out = fn(x.to(dev), torch.from_numpy(modes).to(dev))["out"].cpu()
        runs[str(dev)] = (clean, out, fn.last_result)
    (clean, out, res), (_, cpu_out, cpu_res) = runs[str(cuda)], runs["cpu"]
    codes = res.fault_code.cpu().numpy()
    np.testing.assert_array_equal(codes, [torch_chaos.EXPECT_CODE[int(m)] for m in modes])
    np.testing.assert_array_equal(codes, cpu_res.fault_code.numpy())
    healthy = torch.from_numpy(modes == 0)
    assert torch.equal(out[healthy], clean[healthy])
    torch.testing.assert_close(out, cpu_out, rtol=0, atol=0, equal_nan=True)
    assert res.steps == cpu_res.steps and res.converged
    np.testing.assert_array_equal(res.block_exec, cpu_res.block_exec)


def test_serve_on_cuda_matches_its_oracle(cuda):
    """Float32 smoke SmolLM, 2 lanes, 5 requests arriving on a virtual
    clock: every completion equals the sequential oracle, and K4 launches
    once per layer of every decode execution of the run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke_config("smollm-135m")
    model = get_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    kw = dict(max_context=32, max_prompt_len=5, max_new_tokens=6, requests_per_lane=1,
              eos_id=0)
    eng = GenerationEngine(model, params, EngineConfig(lanes=2, segment_steps=4, **kw))
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, 1 + i % 5).astype(np.int32),
                    arrival=float(i)) for i in range(5)]
    eng.serve(reqs[:1])  # a first serve: lowering and the VM
    t = {"now": 0.0}

    def clock():
        t["now"] += 1.0
        return t["now"]

    fd_ops.decode_attention.launches = 0
    comps, stats = eng.serve(reqs, now_fn=clock)
    execs = eng.last_serve_result.tag_stats["decode"][0]
    assert fd_ops.decode_attention.launches == cfg.num_layers * execs > 0
    oracle = GenerationEngine(model, params, EngineConfig(lanes=5, **kw))
    prompts = np.zeros((5, 1, 5), np.int32)
    plens = np.zeros((5, 1), np.int32)
    for i, r in enumerate(reqs):
        prompts[i, 0, : len(r.prompt)] = r.prompt
        plens[i, 0] = len(r.prompt)
    ref_out = oracle.reference_generate(prompts, plens)
    assert stats.ok == 5
    for c in comps:
        np.testing.assert_array_equal(c.tokens, ref_out["tokens"][c.rid, 0, : ref_out["lengths"][c.rid, 0]])


def test_traced_and_pgo_nuts_on_cuda_are_bit_exact(cuda):
    """NUTS on the card: a traced run equals the plain one (outputs,
    dispatches, block_exec, K1/K2 launches) and its trace the CPU's; the
    profile-guided kernel equals it too, with fewer dispatches and K1/K2
    launches = block_exec x the re-lowered blocks' groups."""
    from repro_torch.obs import block_profile

    settings = nuts.NutsSettings(max_tree_depth=5, num_steps=3, steps_per_leaf=2)
    runs = {}
    for dev in ("cpu", cuda):
        target = targets.logistic_regression(200, 8, device=dev)
        kern = nuts.make_nuts_kernel(target, settings, device=dev)
        args = nuts.initial_state(target, 16, eps=0.05, seed=5, device=dev)
        traced = kern.with_options(trace=True)
        runs[str(dev)] = (kern, traced, args, traced(*args))
    kern, traced, args, t_out = runs[str(cuda)]
    ops.masked_push.launches = ops.masked_peek.launches = 0
    out = kern(*args)
    launches = (ops.masked_push.launches, ops.masked_peek.launches)
    ops.masked_push.launches = ops.masked_peek.launches = 0
    t_out = traced(*args)
    assert (ops.masked_push.launches, ops.masked_peek.launches) == launches
    for k in out:
        assert torch.equal(t_out[k], out[k])
    res, t_res = kern.last_result, traced.last_result
    assert t_res.steps == res.steps
    np.testing.assert_array_equal(t_res.block_exec, res.block_exec)
    cpu_tr, tr = runs["cpu"][1].last_trace, traced.last_trace
    for f in ("block", "resident", "active", "live", "tile_capacity", "faults"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(cpu_tr, f), err_msg=f)
    opt = kern.optimize(block_profile(tr))
    opt(*args)
    ops.masked_push.launches = ops.masked_peek.launches = 0
    o_out = opt(*args)
    for k in out:
        assert torch.equal(o_out[k], out[k])
    o_res = opt.last_result
    assert o_res.steps < res.steps
    assert opt.scheduler_stats.masked_updates < kern.scheduler_stats.masked_updates
    from chip_smoke import _group_launches

    want = tuple(sum(int(n) * _group_launches(blk, op, term)
                     for n, blk in zip(o_res.block_exec, opt.lowered.blocks))
                 for op, term in ((ir.LPush, ir.LPushJump), (ir.LPop, ir.LReturn)))
    assert (ops.masked_push.launches, ops.masked_peek.launches) == want


def test_engine_program_verifies_on_cuda(cuda):
    """``verify=True`` lowering of the engine's program on the card: the
    decode prim types on fake tensors, K4 answering by its shape rule, so
    no kernel launches."""
    from repro_torch import fake

    cfg = configs.get_smoke_config("smollm-135m")
    model = get_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    eng = GenerationEngine(model, params, EngineConfig(lanes=4, max_context=32,
                                                       max_prompt_len=6, max_new_tokens=8,
                                                       requests_per_lane=2))
    fd_ops.decode_attention.launches = fa_ops.flash_attention.launches = 0
    low = eng.batched.with_options(verify=True).lowered
    assert low.device.type == "cuda" and fd_ops.decode_attention.launches == 0
    with fake.fake_mode():
        q, k, v, count = (torch.empty(s, dtype=d, device=cuda) for s, d in (
            ((2, 9, 64), torch.bfloat16), ((2, 16, 3, 64), torch.bfloat16),
            ((2, 16, 3, 64), torch.bfloat16), ((2,), torch.int32)))
        out = fd_ops.decode_attention(q, k, v, count)
        qa = torch.empty((1, 64, 9, 64), dtype=torch.bfloat16, device=cuda)
        ka = torch.empty((1, 64, 3, 64), dtype=torch.bfloat16, device=cuda)
        att = fa_ops.flash_attention(qa, ka, ka, causal=True)
    assert fake.is_fake(out, att)
    assert (out.shape, out.dtype, out.device.type) == ((2, 9, 64), torch.bfloat16, "cuda")
    assert (att.shape, att.dtype) == ((1, 64, 9, 64), torch.bfloat16)
    assert fd_ops.decode_attention.launches == fa_ops.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# Training (the train step, checkpoints) and the kernels under autograd
# ---------------------------------------------------------------------------


def _train_parts(device):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import data, optimizer, train_step

    cfg = configs.get_smoke_config("smollm-135m")  # float32 compute
    model = get_model(cfg, device=device)
    params = model.init(torch.Generator().manual_seed(0))
    ocfg = optimizer.OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=100)
    tcfg = train_step.TrainConfig(microbatches=2, remat="dots", opt=ocfg)
    batch = data.SyntheticStream(model, ShapeSpec("t", 32, 4, "train")).batch(3)
    return model, params, optimizer.init_opt_state(params, ocfg), tcfg, batch


def test_train_step_on_cuda_matches_cpu(cuda):
    """One train step (float32, 2 microbatches, remat "dots") on the card
    and on the CPU from the same weights and batch: loss within 1e-5
    relative, gradients within 1e-4 of each leaf's largest magnitude, the
    updated masters within 1e-5 + 2 x lr (Adam's sign flips near zero).
    TF32 is switched off so both sides multiply in float32."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.train import train_step

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda):
            model, params, state, tcfg, batch = _train_parts(dev)
            loss_fn = train_step.make_loss_fn(model, tcfg)
            (loss, _), grads = train_step._value_and_grad(loss_fn, params, batch)
            new_p, new_s, m = train_step.make_train_step(model, tcfg)(params, state, batch)
            out[str(dev)] = (loss, grads, new_p, new_s, m)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    c, g = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(g[0]), float(c[0]), rtol=1e-5)
    np.testing.assert_allclose(float(g[4]["loss"]), float(c[4]["loss"]), rtol=1e-5)
    for a, b in zip(tree_flatten(g[1])[0], tree_flatten(c[1])[0]):
        b = b.numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-30))
    for a, b in zip(tree_flatten(g[2])[0], tree_flatten(c[2])[0]):
        assert a.device.type == "cuda" and a.dtype == torch.float32
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-5 + 2e-3)
    assert int(g[3]["step"]) == 1 and g[3]["step"].device.type == "cuda"


def test_checkpoint_written_on_cuda_reads_on_the_cpu(cuda, tmp_path):
    """(params, AdamW state) and a bf16 leaf saved from the card restore
    onto the CPU with identical bytes, and back onto the card."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.train import checkpoint, fault_tolerance

    _, params, state, _, _ = _train_parts(cuda)
    tree = (params, state, {"w16": torch.randn(3, 8, device=cuda).to(torch.bfloat16)})
    ck = checkpoint.Checkpointer(str(tmp_path))
    ck.save(1, tree)
    ck.wait()
    on_cpu = ck.restore(ck.latest_step(), like=fault_tolerance.reshard(tree, "cpu"))
    back = ck.restore(1, like=tree)
    for a, b, c in zip(tree_flatten(tree)[0], tree_flatten(on_cpu)[0], tree_flatten(back)[0]):
        assert b.device.type == "cpu" and c.device.type == "cuda"
        assert a.dtype == b.dtype == c.dtype
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)


def test_kernels_refuse_autograd_on_cuda(cuda):
    """K3 and K4 have no backward: on the card a call under autograd
    raises instead of returning an output whose gradient stops there; with
    grad mode off they run."""
    q, k, v = (x.to(cuda).requires_grad_(True) for x in attention_inputs(1, 64, 64, 2, 1, 64))
    with pytest.raises(NotImplementedError, match="no backward"):
        fa_ops.flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        fa_ops.flash_attention(q, k, v, causal=True)
    qd, kc, vc, count = (x.to(cuda) for x in decode_inputs(2, 16, 2, 1, 64, seed=1))
    with pytest.raises(NotImplementedError, match="no backward"):
        fd_ops.decode_attention(qd.requires_grad_(True), kc, vc, count)
    with torch.no_grad():
        fd_ops.decode_attention(qd, kc, vc, count)

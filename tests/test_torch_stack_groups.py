"""The VM's grouped stack traffic (``ref.push_group``/``pop_group``, the
groups of ``ops`` and the VM's runs of pushes and pops) on the CPU.

A group is held, bit for bit, to the same pushes and pops done one at a
time through the port's ``masked_push``/``masked_peek`` with the VM's
pointer, flag and select arithmetic, and to the JAX package's Pallas
kernels (interpret mode) with that arithmetic in ``jnp``, over mixed
dtypes and row sizes, pointers out of range and negative, and masks all
off, all on and random.  The VM's runs split where a push's source was
pushed earlier in the run or a variable repeats, and on lowered NUTS they
are the runs of its call and return blocks.  The CUDA kernels themselves
are checked on a card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.stack_ops import ops as j_ops  # noqa: E402
from repro_torch.core import ir, pc_vm  # noqa: E402
from repro_torch.kernels.stack_ops import ops, ref  # noqa: E402
from repro_torch.mcmc import nuts, targets  # noqa: E402
from repro_torch.testing import stack_group_inputs, to_torch  # noqa: E402

D, Z, MAX_DEPTH = 6, 9, 4
DTYPES = (torch.float32, torch.int32, torch.bool, torch.bfloat16)
SHAPES = ((), (2,), (100,))
# Every dtype at every row size: 12 stacks in one group.
SPECS = [ops.StackSpec(D, s, dt) for dt in DTYPES for s in SHAPES]
J_DTYPES = {torch.float32: jnp.float32, torch.int32: jnp.int32, torch.bool: jnp.bool_,
            torch.bfloat16: jnp.bfloat16}


def _torch_entries(entries, specs):
    return [tuple(to_torch(x, s.dtype) if i != 1 else torch.from_numpy(x)
                  for i, x in enumerate(e)) for e, s in zip(entries, specs)]


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _same(a, b):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _where(mask, new, old):
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _push_one_by_one(entries, mask, flags, max_depth):
    """The VM's per-op push: overflow, masked_push, ``+ mask``, masked select."""
    new_ptrs, new_tops = [], []
    for stack, ptr, top, src in entries:
        flags = flags | (mask & (ptr >= max_depth))
        ops.masked_push(stack, ptr, top.contiguous(), mask)
        new_ptrs.append(ptr + mask.to(torch.int32))
        new_tops.append(_where(mask, src, top))
    return new_ptrs, new_tops, flags


def _pop_one_by_one(entries, mask):
    new_ptrs, new_tops = [], []
    for stack, ptr, top in entries:
        new_ptr = ptr - mask.to(torch.int32)
        new_ptrs.append(new_ptr)
        new_tops.append(_where(mask, ops.masked_peek(stack, new_ptr), top))
    return new_ptrs, new_tops


def _jax_push_pop(entries, mask, specs, max_depth):
    """Pallas masked_push / masked_peek entry by entry with the same
    arithmetic in jnp: pushed stacks, new pointers and tops, the flag, and
    the pops of the original stacks."""
    jm = jnp.asarray(mask)
    flags = jnp.zeros_like(jm)
    out = []
    for (stack, ptr, top, src), s in zip(entries, specs):
        dt = J_DTYPES[s.dtype]
        js, jp, jt, jsrc = (jnp.asarray(stack, dt), jnp.asarray(ptr), jnp.asarray(top, dt),
                            jnp.asarray(src, dt))
        b = jm.reshape(jm.shape + (1,) * len(s.shape))
        flags = flags | (jm & (jp >= max_depth))
        pushed = j_ops.masked_push(js, jp, jt, jm)
        pop_ptr = jp - jm.astype(jnp.int32)
        popped = jnp.where(b, j_ops.masked_peek(js, pop_ptr), jt)
        out.append((pushed, jp + jm.astype(jnp.int32), jnp.where(b, jsrc, jt), pop_ptr, popped))
    return out, flags


@pytest.mark.parametrize("mask_kind", ["random", "on", "off"])
def test_groups_match_one_by_one_and_pallas(mask_kind):
    np_entries, np_mask = stack_group_inputs(SPECS, Z, seed=1, mask=mask_kind)
    mask = torch.from_numpy(np_mask)
    assert ((np.stack([e[1] for e in np_entries]) < 0).any()
            and (np.stack([e[1] for e in np_entries]) >= D).any())

    # The group: ref, the checked entry point and a group made once.
    runs = {}
    for name, call in (
        ("ref", lambda e, m, f: ref.push_group(e, m, f, MAX_DEPTH)),
        ("ops", lambda e, m, f: ops.push_group(e, m, f, MAX_DEPTH)),
        ("plan", lambda e, m, f: ops.PushGroup(SPECS, [True] * len(SPECS), Z)(
            e, m, f, MAX_DEPTH)),
    ):
        entries = _torch_entries(np_entries, SPECS)
        flags = torch.zeros(Z, dtype=torch.bool)
        new_ptrs, new_tops = call(entries, mask, flags)
        runs[name] = ([e[0] for e in entries], new_ptrs, new_tops, flags)
    entries = _torch_entries(np_entries, SPECS)
    one = _push_one_by_one(entries, mask, torch.zeros(Z, dtype=torch.bool), MAX_DEPTH)
    want_stacks = [e[0] for e in entries]
    jax_out, jax_flags = _jax_push_pop(np_entries, np_mask, SPECS, MAX_DEPTH)
    for stacks, new_ptrs, new_tops, flags in runs.values():
        assert torch.equal(flags, one[2])
        _same(flags, jax_flags)
        for i in range(len(SPECS)):
            assert torch.equal(stacks[i], want_stacks[i])
            assert torch.equal(new_ptrs[i], one[0][i])
            assert torch.equal(new_tops[i], one[1][i])
            _same(stacks[i], jax_out[i][0])
            _same(new_ptrs[i], jax_out[i][1])
            _same(new_tops[i], jax_out[i][2])

    pop_entries = [(s, p, t) for s, p, t, _ in _torch_entries(np_entries, SPECS)]
    want_ptrs, want_tops = _pop_one_by_one(pop_entries, mask)
    for new_ptrs, new_tops in (ref.pop_group(pop_entries, mask),
                               ops.pop_group(pop_entries, mask),
                               ops.PopGroup(SPECS, Z)(pop_entries, mask)):
        for i in range(len(SPECS)):
            assert torch.equal(new_ptrs[i], want_ptrs[i])
            assert torch.equal(new_tops[i], want_tops[i])
            _same(new_ptrs[i], jax_out[i][3])
            _same(new_tops[i], jax_out[i][4])


def test_overflow_flag_set_only_on_masked_lanes_at_or_past_max_depth():
    spec = ops.StackSpec(D, (), torch.int32)
    stack = torch.zeros((D, Z), dtype=torch.int32)
    ptr = torch.tensor([0, 3, 4, 5, 6, 7, 4, -1, 2], dtype=torch.int32)
    mask = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1, 0], dtype=torch.bool)
    flags = torch.zeros(Z, dtype=torch.bool)
    top = torch.arange(Z, dtype=torch.int32)
    new_ptrs, _ = ops.PushGroup([spec], [False], Z)([(stack, ptr, top, None)], mask, flags,
                                                   MAX_DEPTH)
    assert flags.tolist() == [False, False, True, True, True, True, False, False, False]
    # Dropped where out of range: lanes 4 (ptr 6) and 5 (ptr 7) and 7 (ptr -1).
    assert stack[:, 4].eq(0).all() and stack[:, 5].eq(0).all() and stack[:, 7].eq(0).all()
    assert int(stack[5, 3]) == 3 and int(stack[4, 2]) == 2
    assert torch.equal(new_ptrs[0], ptr + mask.to(torch.int32))


def test_a_broadcast_src_keeps_its_zero_lane_stride():
    """A constant src (stride 0 over the lanes, as the VM broadcasts its
    constants) is handed over as it is, with a lane stride of 0; a dense
    one with its row bytes; any other layout as a contiguous copy."""
    row = ops._Row(ops.StackSpec(D, (3,), torch.float32), Z)
    const = torch.arange(3, dtype=torch.float32).expand(Z, 3)
    x, stride = row.lanes_of(const, "src")
    assert x is const and stride == 0
    dense = torch.zeros((Z, 3))
    assert row.lanes_of(dense, "src") == (dense, 12)
    strided = torch.zeros((3, Z)).t()
    x, stride = row.lanes_of(strided, "src")
    assert x.is_contiguous() and stride == 12
    with pytest.raises(TypeError, match="int32"):
        row.lanes_of(dense.to(torch.int32), "src")
    # Through the group on the CPU: every masked lane takes the constant.
    spec = ops.StackSpec(D, (3,), torch.float32)
    mask = torch.ones(Z, dtype=torch.bool)
    _, tops = ops.push_group([(torch.zeros((D, Z, 3)), torch.zeros(Z, dtype=torch.int32),
                               dense, const)], mask, torch.zeros(Z, dtype=torch.bool), D)
    assert torch.equal(tops[0], const)
    assert ops.PushGroup([spec], [True], Z).rows[0].nbytes == 12


def _block(*ops_, term=None):
    return ir.LBlock(ops=list(ops_), term=term or ir.LReturn())


def _shape(items):
    return [(it[0], [o.var for o in it[1]], it[2]) if isinstance(it, tuple) else "prim"
            for it in items]


def test_runs_split_where_a_src_was_pushed_earlier_or_a_variable_repeats():
    prim = ir.identity_prim("t", "a")
    blk = _block(ir.LPush("a", "x"), ir.LPush("b", "a"), ir.LPush("a", "y"),
                 ir.LPush("c", "c"), prim, ir.LPop("a"), ir.LPop("b"), ir.LPop("a"),
                 term=ir.LPushJump(target=0, ret=1))
    assert _shape(pc_vm.stack_runs(blk)) == [
        ("push", ["a"], False),                 # b's src a was pushed just before
        ("push", ["b", "a", "c"], True),        # the pc push joins the last push run
        "prim",
        ("pop", ["a", "b"], False),
        ("pop", ["a"], False),                  # a repeats
    ]
    ret = _block(ir.LPop("a"), prim, term=ir.LReturn())
    assert _shape(pc_vm.stack_runs(ret)) == [("pop", ["a"], True), "prim"]
    assert _shape(pc_vm.stack_runs(_block(term=ir.LReturn()))) == [("pop", [], True)]
    assert _shape(pc_vm.stack_runs(_block(ir.LPush("a", "b")))) == [
        ("push", ["a"], False), ("pop", [], True)]


I32 = ir.Spec((), torch.int32)


def _split_program(b_spec=I32) -> ir.LoweredProgram:
    """One block that needs both splits: b's src a was pushed in the run,
    and a is pushed and popped twice."""
    q = lambda v: f"f/{v}"  # noqa: E731
    blk = _block(ir.LPush(q("a"), q("x")), ir.LPush(q("b"), q("a")), ir.LPush(q("a"), q("y")),
                 ir.identity_prim(q("ob"), q("b")), ir.identity_prim(q("oa1"), q("a")),
                 ir.LPop(q("a")), ir.LPop(q("a")), ir.identity_prim(q("oa3"), q("a")))
    specs = {q(v): I32 for v in ("x", "y", "a", "ob", "oa1", "oa3")}
    specs[q("b")] = b_spec
    return ir.LoweredProgram(
        blocks=[blk], entry=0, main_params=(q("x"), q("y")),
        main_outputs=(q("ob"), q("oa1"), q("oa3")), var_specs=specs,
        stack_vars=frozenset({q("a"), q("b")}), temp_vars=frozenset(),
        func_entries={"f": 0})


def test_the_vm_gives_the_one_by_one_result_across_split_runs():
    vm = pc_vm.ProgramCounterVM(_split_program(), pc_vm.VMConfig(batch_size=Z, max_depth=4),
                                "cpu")
    assert [(g.kind, g.vars, g.pc) for g in vm.stack_groups[0]] == [
        ("push", ("f/a",), False), ("push", ("f/b", "f/a"), False),
        ("pop", ("f/a",), False), ("pop", ("f/a",), True)]
    x = torch.arange(Z, dtype=torch.int32) + 10
    y = torch.arange(Z, dtype=torch.int32) + 100
    res = vm.run({"f/x": x, "f/y": y})
    assert res.converged
    assert torch.equal(res.outputs["f/ob"], x)   # b took a's new top
    assert torch.equal(res.outputs["f/oa1"], y)
    assert torch.equal(res.outputs["f/oa3"], torch.zeros(Z, dtype=torch.int32))


def test_a_src_of_another_dtype_raises_when_the_vm_is_made():
    with pytest.raises(TypeError, match="source"):
        pc_vm.ProgramCounterVM(_split_program(ir.Spec((), torch.float32)),
                               pc_vm.VMConfig(batch_size=Z, max_depth=4), "cpu")


# Lowered NUTS: the call blocks push runs of 10, 12, 12, 7 and 7 variables
# with the pc, the return blocks pop them (blocks 7 and 9 with the pc).
NUTS_GROUPS = {
    1: [("pop", 0, True)], 2: [("push", 10, True)], 3: [("pop", 10, False)],
    5: [("pop", 0, True)], 6: [("push", 12, True)], 7: [("pop", 12, True)],
    8: [("push", 12, True)], 9: [("pop", 12, True)], 12: [("pop", 0, True)],
    13: [("push", 7, True)], 14: [("pop", 7, False)], 15: [("push", 7, True)],
    16: [("pop", 7, False)], 18: [("push", 0, True)], 20: [("pop", 0, True)],
}


def test_nuts_groups_are_its_call_and_return_runs():
    target = targets.logistic_regression(50, 4, device="cpu")
    settings = nuts.NutsSettings(max_tree_depth=3, num_steps=1, steps_per_leaf=1)
    kern = nuts.make_nuts_kernel(target, settings, device="cpu")
    lowered = kern.lowered
    vm = pc_vm.ProgramCounterVM(lowered, pc_vm.VMConfig(batch_size=4, max_depth=8), "cpu")
    got = {b: [(g.kind, len(g.vars), g.pc) for g in groups]
           for b, groups in enumerate(vm.stack_groups) if groups}
    assert got == NUTS_GROUPS
    for b, groups in enumerate(vm.stack_groups):
        for g in groups:
            kind = ir.LPush if g.kind == "push" else ir.LPop
            assert g.vars == tuple(op.var for op in lowered.blocks[b].ops
                                   if isinstance(op, kind))
            assert len(g.call) == len(g) <= 16

"""What the ranks of the port's lane-sharding tests run.

Each function here runs in every rank that ``repro_torch.distributed.spawn``
starts (``fn(rank, device, ...)``) and returns plain numpy and Python
values for the test to hold against the JAX package's ``mesh=2`` runs and
the port's own unsharded runs.  This module imports no JAX: with ``spawn``
each rank imports it anew.
"""
import warnings

import numpy as np
import torch

from repro_torch import distributed
from repro_torch.core import api, frontend, ir, lowering, pc_vm
from repro_torch.core.batching import Batched, Shared, autobatch
from repro_torch.core.frontend import I32
from repro_torch.kernels.stack_ops import ops as sk_ops
from repro_torch.kernels.stack_ops import ref as sk_ref
from repro_torch.testing import build_fib

#: fib's batch: 8 lanes a rank, one OCCUPANCY_TILE, so tile occupancy is
#: the unsharded run's.
FIB_Z = 16
STEPPER_SEGMENT = 5


def fib_inputs(z: int = FIB_Z) -> np.ndarray:
    return (np.arange(z) % 9).astype(np.int32)


def _host(x) -> np.ndarray:
    return distributed.host_lanes(x).numpy()


def _caught(fn) -> str:
    """The name and message of what ``fn()`` raises ('' when it does not)."""
    try:
        fn()
    except Exception as e:  # the tests match on the name and message
        return f"{type(e).__name__}: {e}"
    return ""


def _vm_result(res) -> dict:
    (out,) = res.outputs.values()
    return dict(
        out=_host(out), steps=res.steps, block_exec=np.asarray(res.block_exec),
        block_active=np.asarray(res.block_active), num_devices=res.sched.num_devices,
        lane_steps=_host(res.lane_steps), occupancy=res.sched.mean_occupancy,
        lane_occupancy=res.sched.mean_lane_occupancy, converged=res.converged,
        masked_updates=res.sched.masked_updates,
    )


def _fib_matrix(device) -> dict:
    """fib at FIB_Z lanes over the mesh under every schedule, with and
    without compaction every dispatch, through the stack groups' plain
    versions (the CPU's)."""
    from torch.distributed.tensor import DTensor, Shard

    low = lowering.lower(build_fib(), device)
    inputs = {ir.qualify("fib", "n"): torch.from_numpy(fib_inputs())}
    out = {}
    for schedule in pc_vm.SCHEDULES:
        for ce in (None, 1):
            cfg = dict(batch_size=FIB_Z, max_depth=24, schedule=schedule, compact_every=ce)
            vm = pc_vm.ProgramCounterVM(low, pc_vm.VMConfig(**cfg, mesh=2), device)
            res = vm.run(inputs)
            (o,) = res.outputs.values()
            rec = _vm_result(res)
            rec.update(
                dtensor=isinstance(o, DTensor) and tuple(o.placements) == (Shard(0),),
                mesh_dims=o.device_mesh.mesh_dim_names, full=o.full_tensor().numpy(),
                local=o.to_local().numpy(), lanes=vm.lanes, offset=vm.lane_offset)
            out[(schedule, ce)] = rec
    # The dispatch trace: sharded and unsharded rings drain to the same events.
    traces = []
    for mesh in (2, None):
        vm = pc_vm.ProgramCounterVM(low, pc_vm.VMConfig(
            batch_size=FIB_Z, max_depth=24, compact_every=3, trace=True, mesh=mesh), device)
        tr = vm.run(inputs).trace
        traces.append({k: np.asarray(getattr(tr, k)) for k in
                       ("steps", "block", "active", "live", "quarantined", "tile_capacity", "compacted",
                        "faults", "resident")})
    out["trace"] = traces
    return out


def _mesh_cases(device) -> dict:
    """resolve_mesh / mesh_cache_key and the checks that refuse a bad
    mesh (tests/test_mesh.py's TestResolveMesh)."""
    from torch.distributed.device_mesh import DeviceMesh

    one = pc_vm.resolve_mesh(1, device.type)
    explicit = DeviceMesh(device.type, [0, 1], mesh_dim_names=(pc_vm.LANE_AXIS,))
    flat2d = DeviceMesh(device.type, [[0, 1]], mesh_dim_names=("a", "b"))
    low = lowering.lower(build_fib(), device)
    return dict(
        none=(pc_vm.resolve_mesh(None) is None, pc_vm.mesh_cache_key(None) is None),
        one=(one.mesh_dim_names, one.size(), one.ndim),
        explicit_passthrough=pc_vm.resolve_mesh(explicit) is explicit,
        same_twice=pc_vm.resolve_mesh(2, device.type) is pc_vm.resolve_mesh(2, device.type),
        two_d=_caught(lambda: pc_vm.resolve_mesh(flat2d)),
        too_many=_caught(lambda: pc_vm.resolve_mesh(3, device.type)),
        nonpositive=_caught(lambda: pc_vm.resolve_mesh(0, device.type)),
        keys=(pc_vm.mesh_cache_key(2), pc_vm.mesh_cache_key(explicit),
              pc_vm.mesh_cache_key(1)),
        explicit_run=_host(pc_vm.ProgramCounterVM(low, pc_vm.VMConfig(
            batch_size=4, max_depth=24, mesh=explicit), device).run(
                {"fib/n": torch.tensor([5, 9, 2, 11], dtype=torch.int32)}).outputs["fib/out"]),
        indivisible=_caught(lambda: pc_vm.ProgramCounterVM(
            low, pc_vm.VMConfig(batch_size=3, mesh=2), device)),
        smaller=_smaller_mesh_run(low, device),
    )


def _smaller_mesh_run(low, device):
    """mesh=1 in the two-rank world: the first rank runs fib alone, the
    other raises that it is not in the mesh, neither waits for the other,
    and both still agree on the groups made after (a sum over a new mesh of
    both ranks)."""
    from torch.distributed.device_mesh import DeviceMesh

    try:
        res = pc_vm.ProgramCounterVM(low, pc_vm.VMConfig(batch_size=4, max_depth=24, mesh=1),
                                     device).run(
            {"fib/n": torch.tensor([5, 9, 2, 11], dtype=torch.int32)})
        got = (_host(res.outputs["fib/out"]), res.sched.num_devices, res.steps)
    except ValueError as e:
        got = f"ValueError: {e}"
    after = DeviceMesh(device.type, [1, 0], mesh_dim_names=(pc_vm.LANE_AXIS,))
    return got, int(distributed.all_reduce_sum(after, torch.ones(1, dtype=torch.int64))[0])


def _double_program():
    pb = frontend.ProgramBuilder()
    fb = pb.function("double", ["x"], ["out"], {"x": I32}, {"out": I32})
    fb.assign("out", lambda x: 2 * x, ["x"])
    fb.return_()
    pb.add(fb)
    return pb.build()


def _clampsum_program():
    pb = frontend.ProgramBuilder()
    fb = pb.function("clampsum", ["x", "cap"], ["tot"], {"x": I32, "cap": I32},
                     {"tot": I32})
    fb.const(0, torch.int32, out="tot")
    with fb.while_(lambda x: x > 0, ["x"]):
        fb.assign("tot", lambda t, x, c: torch.minimum(t + x, c), ["tot", "x", "cap"])
        fb.assign("x", lambda x: x - 1, ["x"])
    fb.return_()
    pb.add(fb)
    return pb


def _api_cases(device) -> dict:
    """The decorator, shared arguments, the deprecated shim and overflow
    under mesh=2 (tests/test_mesh.py's TestAutobatchMesh)."""

    @autobatch(in_specs=(Batched(I32),), out_spec=I32, max_depth=24, device=device)
    def fib(n):
        if n < 2:
            return n
        return fib(n - 1) + fib(n - 2)

    sharded = autobatch(fib.program, max_depth=24, mesh=2, device=device)
    n = torch.from_numpy(fib_inputs(8))
    out = dict(decorator=(_host(sharded(n)["out"]), fib(n).numpy(),
                          sharded.last_result.sched.num_devices))

    f_plain = autobatch(_double_program(), device=device)
    f_mesh = autobatch(_double_program(), mesh=2, device=device)
    x = torch.arange(4, dtype=torch.int32)
    inputs = {"x": x}
    out["cache_key"] = (f_plain._key(inputs, 4) != f_mesh._key(inputs, 4),
                        f_mesh._key(inputs, 4)[-4])
    out["double"] = (_host(f_mesh(x)["out"]), f_plain(x)["out"].numpy())
    again = f_mesh(x)  # a hit: the same executor
    out["double_again"] = (_host(again["out"]), f_mesh.cache_info().hits)

    pb = _clampsum_program()
    kern = autobatch(pb, in_specs=(Batched(I32), Shared(I32)), mesh=2, device=device)
    ref = autobatch(pb, in_specs=(Batched(I32), Shared(I32)), device=device)
    xs = torch.tensor([0, 3, 7, 2], dtype=torch.int32)
    cap = torch.tensor(9, dtype=torch.int32)
    out["shared"] = (_host(kern(xs, cap)["tot"]), ref(xs, cap)["tot"].numpy())

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shim = api.autobatch(build_fib(), 4, max_depth=24, mesh=2, device=device)
    nn = np.array([5, 9, 2, 11], np.int32)
    out["shim"] = (_host(shim({"n": nn})["out"]),
                   any(issubclass(w.category, DeprecationWarning) for w in caught),
                   shim.last_result.sched.num_devices)

    @autobatch(in_specs=(Batched(I32),), out_spec=I32, max_depth=4, mesh=2, device=device)
    def deep(n):
        if n < 1:
            return n
        return deep(n - 1)

    try:
        deep(torch.tensor([9, 0], dtype=torch.int32))
        out["overflow"] = ("", None)
    except pc_vm.StackOverflow as e:
        out["overflow"] = (str(e), np.asarray(e.lanes))
    return out


def _stepper_cases(device) -> dict:
    """Segments with inject and park under the mesh, against one run and
    against the unsharded port doing the same."""
    res = {}
    for mesh in (2, None):
        fn = autobatch(build_fib(), max_depth=24, mesh=mesh, device=device,
                       compact_every=2, schedule="popular")
        n0 = torch.from_numpy(fib_inputs(8))
        whole = _host(fn(n0)["out"])
        st = fn.stepper(n0)
        state = st.init()
        while not st.done(state):
            state = st.step(state, STEPPER_SEGMENT)
        chained = _host(st.result(state)["out"])
        # Refill lanes 1, 4 and 6 (two ranks) with new n, park lane 7 early.
        state = st.init()
        state = st.step(state, STEPPER_SEGMENT)
        mask = np.zeros(8, bool)
        mask[[1, 4, 6]] = True
        n1 = torch.from_numpy(np.where(mask, 10, fib_inputs(8)).astype(np.int32))
        state = st.inject(state, mask, n1)
        state = st.park(state, np.eye(8, dtype=bool)[7])
        while not st.done(state):
            state = st.step(state, STEPPER_SEGMENT)
        done, codes = st.lane_status(state)
        res[mesh] = dict(whole=whole, chained=chained, steps=st.steps(state),
                         refilled=_host(st.outputs(state)["out"]), done=done, codes=codes,
                         lane_done=_host(st.lane_done(state)))
    return res


def _chaos_cases(device) -> dict:
    """The quarantine cell under the mesh (tests/test_faults.py's
    test_quarantine_mesh_cell)."""
    from tools import torch_chaos

    return torch_chaos.run_cell(
        torch_chaos.build_chaos_program(), batch=8,
        modes=torch_chaos.make_modes(8, 0.375, seed=0), schedule="earliest", fuse=True,
        mesh=2, seed=0, device=device)


def shard_local_cases(rank: int, device: torch.device) -> dict:
    """stack_ops.shard_local (tests/test_kernels.py's TestShardedStackOps):
    DTensor push/peek against the plain versions of the whole batch, the
    overflow edge and the per-mesh cache; and the groups a sharded VM makes
    over its rank's lanes against the unsharded group."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import lane_shardings
    from repro_torch.testing import stack_group_inputs, to_torch

    mesh = pc_vm.resolve_mesh(2, device.type)
    lane, stk, _ = lane_shardings(mesh)
    sl = sk_ops.shard_local(mesh)
    push, peek = sl
    half = slice(rank * 2, rank * 2 + 2)

    def shard(x, placement, dim):
        part = x[half] if dim == 0 else x[:, half]
        return DTensor.from_local(part.contiguous().to(device), mesh, placement,
                                  run_check=False)

    out = {"cached": sk_ops.shard_local(mesh) is sl}
    rng = np.random.default_rng(21)
    for feat in ((), (3,), (2, 5)):
        d, z = 6, 4
        stack = torch.from_numpy((rng.normal(size=(d, z) + feat) * 10).astype(np.float32))
        val = torch.from_numpy((rng.normal(size=(z,) + feat) * 10).astype(np.float32))
        ptr = torch.from_numpy(rng.integers(0, d, z).astype(np.int32))
        mask = torch.from_numpy(rng.integers(0, 2, z).astype(bool))
        s_stack = shard(stack, stk, 1)
        pushed = push(s_stack, shard(ptr, lane, 0), shard(val, lane, 0),
                                shard(mask, lane, 0))
        peeked = peek(s_stack, shard(ptr, lane, 0))
        out[("push", feat)] = (distributed.host_lanes(pushed).numpy(),
                               sk_ref.masked_push(stack, ptr, val, mask).numpy(),
                               tuple(pushed.placements) == tuple(stk))
        out[("inputs", feat)] = (stack.numpy(), ptr.numpy(), val.numpy(), mask.numpy())
        out[("peek", feat)] = (distributed.host_lanes(peeked).numpy(),
                               sk_ref.masked_peek(sk_ref.masked_push(stack, ptr, val, mask),
                                                  ptr).numpy())
    # The overflow edge: each rank holds one in-range and one out-of-range lane.
    d, z = 4, 4
    stack = torch.zeros((d, z, 2))
    ptr = torch.tensor([0, d + 3] * 2, dtype=torch.int32)
    pushed = push(shard(stack, stk, 1), shard(ptr, lane, 0),
                            shard(torch.ones((z, 2)), lane, 0),
                            shard(torch.ones(z, dtype=torch.bool), lane, 0))
    out["overflow"] = distributed.host_lanes(pushed).numpy()
    # Groups: this rank's group over its 16 of 32 lanes, as the sharded VM
    # makes it, against the slice of the unsharded group's result.
    specs = [sk_ops.StackSpec(5, (3,), torch.float32), sk_ops.StackSpec(5, (), torch.int32),
             sk_ops.StackSpec(5, (), torch.int32)]
    entries, m = stack_group_inputs(specs, 32, seed=4)
    lanes = slice(rank * 16, rank * 16 + 16)

    def push_entries(part):
        return [(to_torch(s[:, part], sp.dtype).contiguous(), torch.from_numpy(p[part].copy()),
                 to_torch(t[part], sp.dtype), to_torch(v[part], sp.dtype))
                for (s, p, t, v), sp in zip(entries, specs)]

    full, local = push_entries(slice(None)), push_entries(lanes)
    mask = torch.from_numpy(m)
    whole = sk_ops.PushGroup(specs, [True] * 3, 32)(full, mask, torch.zeros(32, dtype=torch.bool), 5)
    mine = sk_ops.PushGroup(specs, [True] * 3, 16)(local, mask[lanes].contiguous(),
                                                torch.zeros(16, dtype=torch.bool), 5)
    out["push_group"] = all(
        torch.equal(a[lanes], b) for a, b in zip(whole[0] + whole[1], mine[0] + mine[1])
    ) and all(torch.equal(f[0][:, lanes], l[0]) for f, l in zip(full, local))
    pop_full = [(s, p, t) for s, p, t, _ in push_entries(slice(None))]
    pop_local = [(s, p, t) for s, p, t, _ in push_entries(lanes)]
    whole = sk_ops.PopGroup(specs, 32)(pop_full, mask)
    mine = sk_ops.PopGroup(specs, 16)(pop_local, mask[lanes].contiguous())
    out["pop_group"] = all(torch.equal(a[lanes], b)
                           for a, b in zip(whole[0] + whole[1], mine[0] + mine[1]))
    low = lowering.lower(build_fib(), device)
    vm = pc_vm.ProgramCounterVM(low, pc_vm.VMConfig(batch_size=32, max_depth=24, mesh=2), device)
    out["group_lanes"] = ({g.call.lanes for gs in vm.stack_groups for g in gs},
                          _caught(lambda: pc_vm.ProgramCounterVM(
                              low, pc_vm.VMConfig(batch_size=31, mesh=2), device)))
    return out


def vm_matrix(rank: int, device: torch.device) -> dict:
    """Everything tests/test_torch_mesh.py holds, in one start of the ranks."""
    return dict(rank=rank, device=str(device), world=distributed.world_size(),
                fib=_fib_matrix(device), mesh=_mesh_cases(device), api=_api_cases(device),
                stepper=_stepper_cases(device), chaos=_chaos_cases(device))


# ---------------------------------------------------------------------------
# The engine over two ranks (tests/test_torch_serve.py, test_torch_serve_open.py)
# ---------------------------------------------------------------------------


def _smoke_engine(device, np_params, kw):
    from repro_torch import configs, interop
    from repro_torch.models import get_model
    from repro_torch.serve.engine import EngineConfig, GenerationEngine

    cfg = configs.get_smoke_config("smollm-135m")
    params = interop.lm_params_from_numpy(np_params, cfg, device)
    return GenerationEngine(get_model(cfg, device=device), params, EngineConfig(**kw))


def engine_generate(rank: int, device: torch.device, np_params, kw, prompts, plens,
                    n_req) -> dict:
    """Closed-loop ``generate`` with the lanes over the mesh."""
    eng = _smoke_engine(device, np_params, dict(kw, mesh=2))
    out = eng.generate(prompts, plens, n_req=n_req)
    res = eng.batched.last_result
    return dict(tokens=out["tokens"], lengths=out["lengths"], utilization=out["utilization"],
                steps=res.steps, num_devices=res.sched.num_devices,
                local_lanes=eng.batched._last_executor.vm.lanes)


def engine_serve(rank: int, device: torch.device, np_params, kw, reqs, segment_steps: int,
                 tick: float) -> dict:
    """Open-loop ``serve`` with the lanes over the mesh, on a virtual clock
    (each rank ticks its own; the first rank's reading is the one used)."""
    from repro_torch.serve.engine import Request

    eng = _smoke_engine(device, np_params, dict(kw, mesh=2))
    t = {"now": 0.0}

    def now():
        t["now"] += tick * (rank + 1)  # the ranks' own clocks disagree
        return t["now"]

    comps, stats = eng.serve([Request(rid=r, prompt=p, arrival=a) for r, p, a in reqs],
                             segment_steps=segment_steps, now_fn=now)
    fields = ("rid", "lane", "status", "attempts", "fault", "arrival", "admitted", "finished")
    return dict(
        comps=[({f: getattr(c, f) for f in fields}, c.tokens) for c in comps],
        stats={f: getattr(stats, f) for f in ("segments", "vm_steps", "completions",
                                              "generated_tokens", "ok", "occupancy")},
        num_devices=eng.last_serve_result.sched.num_devices)

"""Program-counter autobatching VM (paper Algorithm 2) on PyTorch.

The JAX package runs the whole batch as one compiled ``lax.while_loop``
whose body picks a block and dispatches it through ``lax.switch``.  PyTorch
eager has neither, so this VM drives the same loop from the host, one
loop iteration at a time:

  1. the schedule (``VMConfig.schedule``) picks a block on the device and
     the host reads that one index back — one host read per dispatch,
     which is also the liveness test;
  2. stop at ``exit_index`` or at ``max_steps``;
  3. otherwise run that block's Python body, which issues the block's
     tensor operations with every state update masked to the lanes whose
     pc-top selects the block.

Schedules, as in the JAX VM (all bit-exact with each other):

* ``"earliest"`` — the smallest block index any live lane's pc-top points
  at, ``min(pc_top)`` (halted lanes hold ``exit_index``);
* ``"popular"`` — the block where the most live lanes rest (first index
  on ties);
* ``"lookahead"`` — the argmax of ``2*count[b] + sum(count[s] for s in
  successors(b))`` over resident blocks (first index on ties); the
  successor product is an int64 broadcast-and-sum (CUDA has no integer
  matmul);
* ``"sweep"`` — no choice: every block runs once per loop iteration, in
  index order, each under its own mask, so a lane can pass through several
  blocks in one iteration.  The host reads only liveness, once an
  iteration; each block's stack groups launch whether or not a lane rests
  there, and its ``block_exec`` counter (a device tensor under this
  schedule) counts only sweeps in which it had residents.

Recursion is materialized into fixed-shape ``[depth, batch, ...]`` stacks,
so members at *different stack depths* batch together whenever their
pc-tops coincide.  All stack traffic — the variable stacks and the pc
stack — goes through :mod:`repro_torch.kernels.stack_ops` in groups
(:class:`StackGroup`, fixed when the VM is made): each maximal run of a
block's pushes, or of its pops, with the pointer, overflow and select
arithmetic around them, is one call — on a CUDA device one kernel launch
per 16 stacks (pushes write the stack in place), on the CPU the plain
versions.  A ``LPushJump``'s pc push joins the block's last push run and a
``LReturn``'s pc pop its last pop run (no primitive touches the pc state).
No caller keeps a reference to an older stack, so the in-place push is
safe.

Lane compaction (``VMConfig.compact_every=k``): every ``k`` loop
iterations the lane axis of the whole state is permuted by a stable
argsort on ``(liveness, pc_top)``, so lanes resting at one block are
contiguous and halted lanes sink to the end.  Each permuted tensor is a
fresh contiguous one (no reference to the old stacks survives, and the
stack groups keep reading dense rows); ``lane_ids`` records which caller
lane each row holds, and every per-lane result is put back in caller
order.  Schedules read only permutation-invariant statistics, so the
dispatch sequence and every result are bit-exact with the uncompacted run.

Pc, pointer and counter state is int32 as in the JAX VM, so overflow,
``steps`` and the statistics (:class:`SchedulerStats`) match it bit for
bit.  Unbatched primitives run under ``torch.func.vmap``; constants are
evaluated once and broadcast.

Fault containment (``VMConfig.on_fault``, ``detect_nonfinite``,
``lane_step_budget``), as in the JAX VM: each lane carries an int32
``fault_code`` (first fault wins; :data:`FAULT_NAMES`).  A push group's
overflow flags become ``FAULT_STACK_OVERFLOW`` after the group; with
``detect_nonfinite`` every floating write into VM state (a primitive's
state outputs, the new tops of a push) is checked before the masked
write, in the reference's order (each push: overflow, then the new top;
the pc push's overflow at the terminator); the watchdog faults a lane that
is still running once it was active in ``lane_step_budget`` dispatches.
Under ``"quarantine"`` a faulted lane leaves every dispatch mask, the
schedule's statistics and the liveness test, so the batch runs on; under
``"raise"`` with a detector set, the loop stops at the first
non-finite or watchdog fault.  Both fold into the one value the host
reads a dispatch.

Segments: :meth:`ProgramCounterVM.init_state` makes a state,
:meth:`ProgramCounterVM.run_segment` runs at most ``num_steps`` more loop
iterations of the same host loop, so a chain of segments is bit-exact with
one :meth:`ProgramCounterVM.run`.  Between segments
:meth:`ProgramCounterVM.park` sends lanes to the exit block and
:meth:`ProgramCounterVM.inject` re-initializes lanes with fresh inputs;
both take caller-order masks and write into the state's tensors in place
(their shapes, dtypes and layouts stay as the stack groups expect).

Dispatch tracing (``VMConfig.trace``: ``True`` or a capacity in events),
as in the JAX VM: the state carries a ring of one event per loop
iteration at slot ``steps % capacity`` — the block (``SWEEP_BLOCK`` for a
sweep), the live residents of every block before it, its active lanes,
the live and quarantined lanes, the occupied-tile capacity, whether
compaction ran after it and the faulted lanes after it.  The ring is one
int32 ``[capacity, 7 + num_blocks]`` tensor whose columns are the JAX
VM's eight buffers (:data:`TRACE_COLUMNS`); each event is written by the
device, one row a dispatch and the fault count after it, and nothing
reads it back until :meth:`ProgramCounterVM.get_trace` drains it into a
:class:`repro_torch.obs.trace.DispatchTrace`.  No traced value feeds
``pick``, a mask or a block, so a traced run is bit-exact with an
untraced one; with tracing off no kernel is added.

Every dispatch runs inside ``torch.profiler.record_function(
"pcvm.block<i>")``, so a device profile attributes time to blocks (the
JAX VM labels its HLO alike); the scope launches no kernel.

A profile-guided program (``passes.pgo_passes``) may pack state variables
of one spec into one ``[batch, k, ...]`` array (``LoweredProgram.
state_layout``); every boundary — :meth:`ProgramCounterVM.init_state`,
:meth:`~ProgramCounterVM.inject`, :meth:`~ProgramCounterVM.result` and the
Stepper's outputs — reads and writes a member as ``tops[packed][:, slot]``
(:meth:`ProgramCounterVM.read_top`).  Packing touches state variables
only, so no stack group addresses a member.

Lane sharding (``VMConfig.mesh``): the JAX VM is one SPMD program over a
single-controller ``Mesh``.  Here each rank of a ``torch.distributed``
process group runs this host loop over its own slice of the lanes
(:mod:`repro_torch.distributed`): with ``mesh=n`` (or a 1-D
``DeviceMesh``) and a batch ``z`` that ``n`` divides, rank ``r`` keeps
lanes ``[r*z/n, (r+1)*z/n)`` on its own device; every caller-facing
argument (inputs, ``inject``/``park`` masks) is the whole batch, as the
JAX caller passes it.  Each dispatch, the ranks sum their live lanes'
per-block counts and the fail-fast flag in one int64 all-reduce on a CPU
``gloo`` group, and every schedule picks from the global counts
(``earliest``: the first block with a count, ``popular``/``lookahead``:
the first maximum, ``sweep``: liveness from the sum), so every rank runs
the same dispatch sequence as the unsharded VM, bit for bit.  Block bodies
and their stack groups touch only the rank's lanes; compaction permutes
within a rank.  ``block_exec`` and ``steps`` are the same on every rank;
``block_active``, the tile counter, ``converged`` and the trace ring's
counts are summed once, when
:meth:`ProgramCounterVM.result` or :meth:`~ProgramCounterVM.get_trace`
reads them (a collective: every rank calls them), and a sweep's
``block_exec`` rides on the next liveness reduction.  The tile occupancy
equals the unsharded run's when ``z/n`` is a multiple of
:data:`OCCUPANCY_TILE` (a tile never spans two ranks) and lanes are not
compacted (compaction packs tiles within a rank only).  Per-lane results
are ``DTensor``s sharded on :data:`LANE_AXIS`
(:func:`repro_torch.distributed.host_lanes` gathers one to the host).

The VM exposes one loop iteration at a time (:meth:`ProgramCounterVM.pick`
/ :meth:`ProgramCounterVM.dispatch`, :meth:`ProgramCounterVM.sweep`) as
well as :meth:`ProgramCounterVM.run`, so tests can replay the dispatch
sequence against an independent oracle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import distributed
from ..distributed import LANE_AXIS
from ..kernels.stack_ops import ops as stack_ops
from ..launch import op_cost
from ..launch import sharding as _sharding
from ..obs import trace as obs_trace
from . import ir

_I32 = torch.int32


class StackOverflow(RuntimeError):
    """A member's pc or variable stack exceeded ``max_depth``.

    Out-of-range pushes are dropped, so overflowing members produce invalid
    results while other members stay exact.  ``depth_exceeded`` is the
    ``[batch]`` bool overflow mask (host numpy) and ``lanes`` the sorted
    offending lane indices.
    """

    def __init__(
        self,
        message: str,
        *,
        depth_exceeded: Optional[np.ndarray] = None,
        lanes: Optional[np.ndarray] = None,
    ):
        super().__init__(message)
        self.depth_exceeded = depth_exceeded
        if lanes is None and depth_exceeded is not None:
            lanes = np.flatnonzero(np.asarray(depth_exceeded))
        self.lanes = lanes


class LaneFault(RuntimeError):
    """One or more lanes faulted (non-finite write or watchdog) under
    ``on_fault="raise"``.

    ``fault_codes`` is the ``[batch]`` int32 code array (host numpy, see
    :data:`FAULT_NAMES`), ``lanes`` the faulted lanes and ``faults``
    ``{lane: name}`` for them.
    """

    def __init__(self, message: str, *, fault_codes: np.ndarray):
        super().__init__(message)
        codes = np.asarray(fault_codes)
        self.fault_codes = codes
        self.lanes = np.flatnonzero(codes != FAULT_OK)
        self.faults = {int(i): FAULT_NAMES[int(codes[i])] for i in self.lanes}


SCHEDULES = ("earliest", "popular", "sweep", "lookahead")

#: Fault policies (``VMConfig.on_fault``): ``"raise"`` makes faults fatal
#: to the batch (the executor raises after the run); ``"quarantine"`` takes
#: faulted lanes out of every dispatch, so the batch runs on.
ON_FAULT = ("raise", "quarantine")

# Per-lane fault codes (int32, first fault wins; 0 = healthy).
FAULT_OK = 0
FAULT_STACK_OVERFLOW = 1  # a push landed at or beyond max_depth
FAULT_NONFINITE = 2  # a masked state write produced NaN/Inf (opt-in)
FAULT_WATCHDOG = 3  # a lane exceeded its per-lane step budget (opt-in)

#: Names, indexed by fault code.
FAULT_NAMES = ("ok", "stack_overflow", "nonfinite", "watchdog")

#: SIMD tile width (lanes) of the occupancy metric, as in the JAX VM: a
#: dispatch's occupancy is its active lanes over the capacity of the tiles
#: holding at least one active lane.
OCCUPANCY_TILE = 8

#: The dispatch-trace ring's columns (the JAX VM's eight buffers, in the
#: names :func:`repro_torch.obs.trace.drain` reads): one int32 column each,
#: then ``resident`` over the last ``num_blocks`` columns.
TRACE_COLUMNS = ("block", "active", "live", "quarantined", "tile",
                 "compacted", "faults")
_FAULTS_COL = TRACE_COLUMNS.index("faults")
# Columns that are the same on every rank (the rest are lane counts).
_RANK_INVARIANT_COLS = (TRACE_COLUMNS.index("block"), TRACE_COLUMNS.index("compacted"))


def _is_device_mesh(mesh: Any) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def _rank_count(n: Any) -> int:
    """An int mesh spec's rank count, checked against the process group."""
    n = int(n)
    if n < 1:
        raise ValueError(f"mesh rank count must be >= 1, got {n}")
    world = distributed.world_size()
    if n > world:
        have = (f"the process group has {world}" if world
                else "no torch.distributed process group is initialized")
        raise ValueError(
            f"mesh={n} needs {n} ranks but {have}; start one process per rank "
            f"(torchrun --nproc-per-node {n}, or repro_torch.distributed.spawn) "
            "and call torch.distributed.init_process_group in each")
    return n


def mesh_size(mesh: Any) -> int:
    """Ranks of a mesh spec (None: 1), without touching the process group."""
    if mesh is None:
        return 1
    return mesh.size() if _is_device_mesh(mesh) else int(mesh)


def resolve_mesh(mesh: Any, device_type: str = "cuda"):
    """Normalize a ``VMConfig.mesh`` value to a 1-D ``DeviceMesh``.

    Accepts ``None`` (no sharding), an int rank count ``n`` (the mesh over
    ranks ``0..n-1`` of the default process group, its dim named
    :data:`LANE_AXIS`, on ``device_type``), or an explicit 1-D
    ``DeviceMesh``.  A 2-D mesh, ``n < 1`` and ``n`` beyond the process
    group (or no group) raise ``ValueError``."""
    if mesh is None:
        return None
    if _is_device_mesh(mesh):
        if mesh.ndim != 1:
            raise ValueError(
                "pc VM lane sharding needs a 1-D mesh (one dim over the batch "
                f"lanes); got dims {mesh.mesh_dim_names or mesh.ndim}")
        return mesh
    return distributed.rank_mesh(_rank_count(mesh), device_type)


def mesh_cache_key(mesh: Any) -> Optional[tuple]:
    """A hashable identity of a mesh spec, for executor cache keys:
    ``None`` stays ``None``; a mesh is ``(dim names, ranks)``, so an int
    spec and the equal explicit mesh share executors."""
    if mesh is None:
        return None
    if _is_device_mesh(mesh):
        resolve_mesh(mesh)  # raises on a 2-D mesh
        return (mesh.mesh_dim_names or (LANE_AXIS,), distributed.mesh_ranks(mesh))
    return ((LANE_AXIS,), tuple(range(_rank_count(mesh))))


@dataclass(frozen=True)
class VMConfig:
    batch_size: int
    max_depth: int = 32  # stack slots (usable call depth = max_depth - 1)
    max_steps: int = 1_000_000
    collect_block_stats: bool = True
    schedule: str = "earliest"  # one of SCHEDULES
    # Permute the lane axis by (liveness, pc-top) every this many loop
    # iterations; None: never.
    compact_every: Optional[int] = None
    # Fault containment: the policy (one of ON_FAULT), the opt-in check of
    # floating state writes, and the per-lane watchdog (dispatches a lane
    # may be active in without halting; None: off).
    on_fault: str = "raise"
    detect_nonfinite: bool = False
    lane_step_budget: Optional[int] = None
    # Run the lowered-IR verifier on the program when the VM is made.
    verify: bool = False
    # Dispatch tracing: None/False off, True the default ring capacity
    # (obs.trace.DEFAULT_TRACE_CAPACITY events), an int that capacity.
    trace: Any = None
    # Lane sharding: None (one device), a rank count, or a 1-D DeviceMesh;
    # batch_size must divide across it (see the module docstring).
    mesh: Any = None

    def __post_init__(self):
        if self.on_fault not in ON_FAULT:
            raise ValueError(
                f"on_fault must be one of {ON_FAULT}, got {self.on_fault!r}"
            )
        if self.lane_step_budget is not None and self.lane_step_budget < 1:
            raise ValueError(
                "lane_step_budget must be >= 1 (or None to disable), got "
                f"{self.lane_step_budget}"
            )
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"schedule must be one of {SCHEDULES}, got {self.schedule!r}"
            )
        if self.compact_every is not None and self.compact_every < 1:
            raise ValueError(
                "compact_every must be >= 1 (or None to disable), got "
                f"{self.compact_every}"
            )
        obs_trace.resolve_capacity(self.trace)  # raises on a bad value


@dataclass(frozen=True)
class SchedulerStats:
    """Per-run scheduling summary (host values), as the JAX VM's.

    With ``collect_block_stats=False`` ``steps`` and ``masked_updates`` are
    None and the occupancies nan."""

    schedule: str
    fused: bool  # whether the program went through superblock fusion
    num_blocks: int
    steps: Optional[int]  # loop iterations (one sweep each for "sweep")
    # Active lanes per dispatch over the capacity of the OCCUPANCY_TILE
    # tiles that held an active lane: what compaction raises.
    mean_occupancy: float
    fused_from: Optional[dict[int, tuple[int, ...]]]
    # Ranks the lane axis was sharded over (1 = unsharded).
    num_devices: int = 1
    # Active lanes per dispatch over the whole batch.
    mean_lane_occupancy: float = float("nan")
    compact_every: Optional[int] = None
    # sum over blocks of block_exec[b] x (masked top writes of block b).
    masked_updates: Optional[int] = None


@dataclass
class VMResult:
    outputs: dict[str, torch.Tensor]  # caller lane order
    steps: int  # loop iterations run (dispatches; sweeps for "sweep")
    converged: bool  # all members halted within max_steps
    # Per-block counters (None without collect_block_stats): times each
    # block ran with residents, and its active lanes summed over them.
    block_exec: Optional[np.ndarray]  # [num_blocks] int32
    block_active: Optional[np.ndarray]  # [num_blocks] int32
    tag_stats: dict[str, tuple[int, int]]  # tag -> (execs, active)
    depth_exceeded: torch.Tensor  # [batch] bool: stack overflowed
    lane_steps: torch.Tensor  # [batch] int32 active-dispatch counts
    sched: SchedulerStats
    fault_code: Optional[torch.Tensor] = None  # [batch] int32, FAULT_NAMES
    # The drained dispatch trace (obs.trace.DispatchTrace) when the run
    # had VMConfig.trace set; None otherwise.
    trace: Optional[Any] = None

    @property
    def fault_mask(self) -> Optional[torch.Tensor]:
        """[batch] bool: lanes that faulted."""
        return None if self.fault_code is None else self.fault_code != FAULT_OK


def tile_capacity(mask: torch.Tensor, caps: torch.Tensor) -> torch.Tensor:
    """Lane capacity (int32 scalar) of the OCCUPANCY_TILE-lane tiles of a
    ``[Z]`` bool mask that hold a set lane; ``caps`` is each tile's width
    (:func:`tile_widths`), a trailing partial tile counting its real
    width."""
    t = OCCUPANCY_TILE
    pad = caps.numel() * t - mask.numel()
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    occupied = mask.view(-1, t).any(dim=1)
    return (occupied * caps).sum(dtype=_I32)


def tile_widths(lanes: int, device) -> torch.Tensor:
    """The int32 widths of the OCCUPANCY_TILE-lane tiles over ``lanes``."""
    t = OCCUPANCY_TILE
    caps = torch.full((-(-lanes // t),), t, dtype=_I32, device=device)
    caps[-1] = lanes - t * (caps.numel() - 1)
    return caps


@dataclass(frozen=True)
class StackGroup:
    """A run of a block's pushes (``kind == "push"``) or pops that runs as one
    stack-ops call: ``vars`` in order (``srcs``: each push's source), then
    the pc stack if ``pc``.  ``call`` is the :class:`stack_ops.PushGroup` or
    :class:`stack_ops.PopGroup` made for it."""

    kind: str
    vars: tuple[str, ...]
    srcs: tuple[str, ...]
    pc: bool
    call: Any

    def __len__(self) -> int:
        return len(self.vars) + self.pc


def stack_runs(blk: ir.LBlock) -> list:
    """The block's ops with each run of pushes or pops gathered into a
    ``(kind, [ops], pc)`` triple.  A run is split where a push's ``src``
    names a variable pushed earlier in it (that push must read the new top)
    or where a variable repeats; the terminator's pc push or pop joins the
    last run of its kind, or ends the block as a run of its own."""
    items: list = []
    for op in blk.ops:
        kind = "push" if isinstance(op, ir.LPush) else "pop" if isinstance(op, ir.LPop) else None
        if kind is None:
            items.append(op)
            continue
        run = items[-1] if items and isinstance(items[-1], list) and items[-1][0] == kind else None
        if run is not None:
            seen = {o.var for o in run[1]}
            if op.var in seen or (kind == "push" and op.src in seen):
                run = None
        if run is None:
            items.append([kind, [op], False])
        else:
            run[1].append(op)
    pc_kind = {ir.LPushJump: "push", ir.LReturn: "pop"}.get(type(blk.term))
    if pc_kind is not None:
        runs = [it for it in items if isinstance(it, list) and it[0] == pc_kind]
        if runs:
            runs[-1][2] = True
        else:
            items.append([pc_kind, [], True])
    return [tuple(it) if isinstance(it, list) else it for it in items]


def _bcast(mask: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Broadcast a [Z] bool mask against a [Z, ...] value."""
    return mask.view(mask.shape + (1,) * (val.dim() - 1))


def _masked(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(_bcast(mask, new), new, old)


class ProgramCounterVM:
    """Host-driven batched executor for a :class:`ir.LoweredProgram`.

    Under a mesh, ``lanes`` is this rank's share of ``config.batch_size``
    and ``lane_offset`` its first lane."""

    def __init__(self, lowered: ir.LoweredProgram, config: VMConfig, device):
        self.lowered = lowered
        self.config = config
        self.device = torch.device(device)
        n = mesh_size(config.mesh)
        if config.batch_size % n:
            raise ValueError(
                f"batch_size={config.batch_size} does not divide across the {n}-rank "
                f"mesh; pick a batch that is a multiple of {n}")
        self.mesh = resolve_mesh(config.mesh, self.device.type)
        self.num_devices, self.lanes, self.lane_offset = 1, config.batch_size, 0
        if self.mesh is not None:
            if self.mesh.device_type != self.device.type:
                raise ValueError(f"the mesh is on {self.mesh.device_type}, the VM on "
                                 f"{self.device}; give them one device type")
            # Every rank of the default group makes the host group, together,
            # before a rank outside the mesh raises (new_group waits for all).
            distributed.host_group(self.mesh)
            coord = self.mesh.get_coordinate()
            if coord is None:
                raise ValueError(f"rank {torch.distributed.get_rank()} is not in the mesh "
                                 f"{distributed.mesh_ranks(self.mesh)}")
            self.num_devices = n
            self.lanes = config.batch_size // n
            self.lane_offset = coord[0] * self.lanes
        if config.verify:
            from . import verifier

            verifier.verify(lowered, device=self.device)
        self.num_blocks = len(lowered.blocks)
        # Dispatch-trace ring capacity (None: tracing off).
        self.trace_capacity = obs_trace.resolve_capacity(config.trace)
        self._state_vars = [
            v for v in sorted(lowered.var_specs) if v not in lowered.temp_vars
        ]
        # Constants are evaluated once, on the device (the JAX VM traces
        # them once into the loop body).
        self._consts: dict[int, tuple[torch.Tensor, ...]] = {}
        self._vmapped: dict[int, Callable] = {}
        for blk in lowered.blocks:
            for op in blk.ops:
                if not isinstance(op, ir.LPrim) or op.fn is ir.identity:
                    continue
                if not op.ins and not op.batched:
                    outs = op.fn()
                    outs = outs if isinstance(outs, tuple) else (outs,)
                    self._consts[id(op)] = tuple(
                        torch.as_tensor(o).to(self.device) for o in outs
                    )
                elif not op.batched:
                    self._vmapped[id(op)] = torch.func.vmap(op.fn)
        # Per block, its stack groups in order (see stack_runs).
        self.stack_groups: list[list[StackGroup]] = []
        self._block_fns = [
            self._make_block_fn(i, blk) for i, blk in enumerate(lowered.blocks)
        ]
        # tag -> [(block_idx, multiplicity)] for post-run instrumentation.
        self._tag_blocks: dict[str, list[tuple[int, int]]] = {}
        for i, blk in enumerate(lowered.blocks):
            for op in blk.ops:
                if isinstance(op, ir.LPrim) and op.tag:
                    self._tag_blocks.setdefault(op.tag, []).append((i, 1))
        # Masked top writes of one dispatch of each block (a primitive's
        # outputs that land in VM state, one per push or pop), as the JAX
        # VM counts them for SchedulerStats.masked_updates.
        self._masked_writes = [
            sum(len([o for o in op.outs if o not in lowered.temp_vars])
                if isinstance(op, ir.LPrim) else 1 for op in blk.ops)
            for blk in lowered.blocks
        ]
        nb, dev = self.num_blocks, self.device
        self._tile_caps = tile_widths(self.lanes, dev)
        self._block_ids = torch.arange(nb, dtype=_I32, device=dev).unsqueeze(1)
        # "lookahead": the [B, B] 0/1 successor matrix (LPushJump: the
        # callee entry only; LReturn: none), int64 for the product.
        succ = np.zeros((nb, nb), np.int64)
        for i, blk in enumerate(lowered.blocks):
            t = blk.term
            targets = ((t.target,) if isinstance(t, (ir.LJump, ir.LPushJump))
                       else (t.true, t.false) if isinstance(t, ir.LBranch) else ())
            for b in targets:
                if 0 <= b < nb:
                    succ[i, b] = 1
        self._succ_host = succ
        self._succ = torch.from_numpy(succ).to(dev)
        # The trace ring's constant cells: each block id as a [1] view
        # (the exit index selects SWEEP_BLOCK) and the compaction flags.
        self._trace_block = torch.tensor(
            list(range(nb)) + [obs_trace.SWEEP_BLOCK], dtype=_I32, device=dev
        ).unsqueeze(1)
        self._trace_flag = torch.tensor([[0], [1]], dtype=_I32, device=dev)

    # ------------------------------------------------------------------
    # Packed state layout
    # ------------------------------------------------------------------

    def _layout_slot(self, v: str) -> Optional[tuple[str, int]]:
        """``(packed_var, slot)`` when ``v`` lives in a packed layout group
        (``ir.StateLayout``), else None."""
        layout = self.lowered.state_layout
        return None if layout is None else layout.slot_of(v)

    def read_top(self, state: dict[str, Any], v: str) -> torch.Tensor:
        """The ``[batch, ...]`` top of a cross-block variable in row order,
        a packed member sliced out of its group (a view)."""
        slot = self._layout_slot(v)
        if slot is None:
            return state["tops"][v]
        packed, idx = slot
        return state["tops"][packed][:, idx]

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's lanes of a whole-batch ``[batch, ...]`` tensor."""
        if self.mesh is None:
            return x
        return x[self.lane_offset:self.lane_offset + self.lanes]

    def _sharded(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """A per-lane tensor of this rank as the whole batch: a ``DTensor``
        sharded on :data:`LANE_AXIS` along ``dim`` (unsharded: ``x``)."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor

        lane, stack, _ = _sharding.lane_shardings(self.mesh)
        return DTensor.from_local(x, self.mesh, lane if dim == 0 else stack, run_check=False)

    def _all_reduce(self, x: torch.Tensor) -> np.ndarray:
        """A rank's int64 counts summed over the mesh (one host read and one
        gloo all-reduce)."""
        return distributed.all_reduce_sum(self.mesh, x.cpu()).numpy()

    def init_state(self, inputs: dict[str, torch.Tensor]) -> dict[str, Any]:
        """A fresh state of whole-batch ``inputs`` (under a mesh, this rank
        keeps its lanes)."""
        z, d = self.lanes, self.config.max_depth
        lp, dev = self.lowered, self.device
        tops: dict[str, torch.Tensor] = {}
        stacks: dict[str, torch.Tensor] = {}
        ptrs: dict[str, torch.Tensor] = {}
        for v in self._state_vars:
            spec = lp.var_specs[v]
            tops[v] = torch.zeros((z,) + spec.shape, dtype=spec.dtype, device=dev)
            if v in lp.stack_vars:
                stacks[v] = torch.zeros(
                    (d, z) + spec.shape, dtype=spec.dtype, device=dev
                )
                ptrs[v] = torch.zeros((z,), dtype=_I32, device=dev)
        for p in lp.main_params:
            spec = lp.var_specs[p]
            x = torch.as_tensor(inputs[p])
            if tuple(x.shape) != (self.config.batch_size,) + spec.shape:
                raise ValueError(
                    f"input {p!r}: expected batched shape "
                    f"{(self.config.batch_size,) + spec.shape}, got {tuple(x.shape)}"
                )
            x = self._local(x).to(device=dev, dtype=spec.dtype)
            slot = self._layout_slot(p)
            if slot is None:
                # A copy of its own: inject writes the tops in place.
                tops[p] = x.clone(memory_format=torch.contiguous_format)
            else:
                # A packed member's home is its slot of the group.
                packed, idx = slot
                tops[packed][:, idx] = x
        state = {
            "pc_top": torch.full((z,), lp.entry, dtype=_I32, device=dev),
            # Slot 0 holds the exit sentinel.
            "pc_stack": torch.full((d, z), lp.exit_index, dtype=_I32, device=dev),
            "pc_ptr": torch.ones((z,), dtype=_I32, device=dev),
            "tops": tops,
            "stacks": stacks,
            "ptrs": ptrs,
            "steps": 0,
            # Per-member overflow flag: set when a push would land at or
            # beyond max_depth (the push drops it, invalidating the member).
            "depth_exceeded": torch.zeros((z,), dtype=torch.bool, device=dev),
            "lane_steps": torch.zeros((z,), dtype=_I32, device=dev),
            # Per-lane fault code (FAULT_*); first fault wins, inject clears.
            "fault_code": torch.zeros((z,), dtype=_I32, device=dev),
        }
        if self.config.compact_every is not None:
            # Which caller lane each row holds (compaction permutes rows).
            state["lane_ids"] = torch.arange(self.lane_offset, self.lane_offset + z,
                                             dtype=_I32, device=dev)
        if self.config.collect_block_stats:
            nb = self.num_blocks
            # The switch schedules bump block_exec from the host, which
            # knows the block; an unsharded sweep counts on the device, a
            # sharded one from the summed counts.
            state["block_exec"] = (
                torch.zeros((nb,), dtype=_I32, device=dev)
                if self.config.schedule == "sweep" and self.mesh is None
                else np.zeros((nb,), np.int32)
            )
            state["block_active"] = torch.zeros((nb,), dtype=_I32, device=dev)
            # Occupied-tile capacity summed over dispatches.
            state["tile_acc"] = torch.zeros((), dtype=_I32, device=dev)
        if self.trace_capacity is not None:
            # The dispatch-trace ring (TRACE_COLUMNS, then resident);
            # an unwritten slot holds block -1.
            ring = torch.zeros((self.trace_capacity, len(TRACE_COLUMNS) + self.num_blocks),
                               dtype=_I32, device=dev)
            ring[:, 0] = -1
            state["trace"] = ring
        return state

    # ------------------------------------------------------------------
    # Block bodies
    # ------------------------------------------------------------------

    def _stack_group(self, kind: str, ops: list, pc: bool) -> StackGroup:
        lp, cfg = self.lowered, self.config
        specs, srcs = [], []
        for op in ops:
            spec = lp.var_specs[op.var]
            if kind == "push":
                src = lp.var_specs[op.src]
                if (src.shape, src.dtype) != (spec.shape, spec.dtype):
                    raise TypeError(
                        f"push {op.var} <- {op.src}: the source is {src.dtype} "
                        f"{src.shape}, the variable {spec.dtype} {spec.shape}"
                    )
                srcs.append(op.src)
            specs.append(stack_ops.StackSpec(cfg.max_depth, spec.shape, spec.dtype))
        if pc:
            specs.append(stack_ops.StackSpec(cfg.max_depth, (), _I32))
        layout = lp.state_layout
        if layout is not None:
            packed = layout.members() & {op.var for op in ops}
            assert not packed, f"a stack group addresses packed members {sorted(packed)}"
        # Under a mesh, over this rank's lanes only.
        if kind == "push":
            call = stack_ops.PushGroup(specs, [True] * len(ops) + [False] * pc, self.lanes)
        else:
            call = stack_ops.PopGroup(specs, self.lanes)
        return StackGroup(kind, tuple(op.var for op in ops), tuple(srcs), pc, call)

    def _make_block_fn(self, bidx: int, blk: ir.LBlock) -> Callable:
        temp_vars = self.lowered.temp_vars
        max_depth = self.config.max_depth
        detect_nonfinite = self.config.detect_nonfinite
        budget = self.config.lane_step_budget
        exit_idx = self.lowered.exit_index
        consts, vmapped = self._consts, self._vmapped
        t = blk.term
        items = [
            it if isinstance(it, ir.LPrim) else self._stack_group(*it)
            for it in stack_runs(blk)
        ]
        self.stack_groups.append([it for it in items if isinstance(it, StackGroup)])
        pushes = any(isinstance(it, StackGroup) and it.kind == "push" for it in items)
        branch_targets = ret_top = None
        if isinstance(t, ir.LBranch):
            branch_targets = (
                torch.tensor(t.true, dtype=_I32, device=self.device),
                torch.tensor(t.false, dtype=_I32, device=self.device),
            )
        elif isinstance(t, ir.LPushJump):
            # The return address, the pc push's old top.
            ret_top = torch.full((self.lanes,), t.ret, dtype=_I32, device=self.device)

        def run(state: dict[str, Any], mask: torch.Tensor) -> None:
            imask = mask.to(_I32)
            z = mask.shape[0]
            tops, stacks, ptrs = state["tops"], state["stacks"], state["ptrs"]
            temps: dict[str, torch.Tensor] = {}

            def set_fault(where: torch.Tensor, code: int) -> None:
                # First fault wins: only healthy lanes take a new code.
                fc = state["fault_code"]
                state["fault_code"] = torch.where(where & (fc == FAULT_OK), code, fc)

            def check_finite(val: torch.Tensor) -> None:
                if not (val.is_floating_point() or val.is_complex()):
                    return
                bad = ~torch.isfinite(val)
                if bad.dim() > 1:
                    bad = bad.flatten(1).any(dim=1)
                set_fault(mask & bad, FAULT_NONFINITE)

            def read(v: str) -> torch.Tensor:
                return temps[v] if v in temp_vars else tops[v]

            def write(v: str, val: torch.Tensor) -> None:
                if v in temp_vars:
                    temps[v] = val
                else:
                    if detect_nonfinite:
                        check_finite(val)
                    tops[v] = _masked(mask, val.to(tops[v].dtype), tops[v])

            for op in items:
                if isinstance(op, ir.LPrim):
                    if op.fn is ir.identity:
                        outs = (read(op.ins[0]),)
                    elif id(op) in consts:
                        # Nullary primitive (constant): broadcast to the batch.
                        outs = tuple(c.expand((z,) + c.shape) for c in consts[id(op)])
                    else:
                        fn = op.fn if op.batched else vmapped[id(op)]
                        outs = fn(*[read(i) for i in op.ins])
                        if len(op.outs) == 1:
                            outs = (outs,)
                    for name, val in zip(op.outs, outs):
                        write(name, val)
                elif op.kind == "push":
                    entries = [(stacks[v], ptrs[v], tops[v], read(s))
                               for v, s in zip(op.vars, op.srcs)]
                    if detect_nonfinite:
                        # The reference's order, push by push: overflow,
                        # then the new top (no src is pushed in the group).
                        for _, ptr, _, src in entries:
                            set_fault(mask & (ptr >= max_depth), FAULT_STACK_OVERFLOW)
                            check_finite(src)
                    if op.pc:
                        entries.append((state["pc_stack"], state["pc_ptr"], ret_top, None))
                    new_ptrs, new_tops = op.call(entries, mask, state["depth_exceeded"],
                                                 max_depth)
                    for v, p, top in zip(op.vars, new_ptrs, new_tops):
                        ptrs[v], tops[v] = p, top
                    if op.pc:
                        state["pc_ptr"] = new_ptrs[-1]
                else:
                    entries = [(stacks[v], ptrs[v], tops[v]) for v in op.vars]
                    if op.pc:
                        entries.append((state["pc_stack"], state["pc_ptr"], state["pc_top"]))
                    new_ptrs, new_tops = op.call(entries, mask)
                    for v, p, top in zip(op.vars, new_ptrs, new_tops):
                        ptrs[v], tops[v] = p, top
                    if op.pc:
                        state["pc_ptr"], state["pc_top"] = new_ptrs[-1], new_tops[-1]

            # The pc stack's push or pop already ran in its group.
            pc_top = state["pc_top"]
            if isinstance(t, (ir.LJump, ir.LPushJump)):
                pc_top = pc_top.masked_fill(mask, t.target)
            elif isinstance(t, ir.LBranch):
                cond = read(t.var)
                cond = cond if cond.dtype == torch.bool else cond != 0
                chosen = torch.where(cond, *branch_targets)
                pc_top = torch.where(mask, chosen, pc_top)
            elif not isinstance(t, ir.LReturn):  # pragma: no cover
                raise AssertionError(t)
            state["pc_top"] = pc_top
            if pushes:
                # The groups set each overflowing lane's flag; a lane that
                # has one and no code yet overflowed in this block (the pc
                # push's, at the terminator, comes after every other write).
                set_fault(state["depth_exceeded"], FAULT_STACK_OVERFLOW)
            lane_steps = state["lane_steps"] + imask
            state["lane_steps"] = lane_steps
            if budget is not None:
                # Watchdog: a lane that used up its budget without halting.
                set_fault(mask & (lane_steps >= budget) & (pc_top < exit_idx),
                          FAULT_WATCHDOG)

        scope = f"pcvm.block{bidx}"

        def scoped_run(state: dict[str, Any], mask: torch.Tensor) -> None:
            # Names the block in device profiles and in an op counter's
            # scopes; launches nothing.
            with torch.profiler.record_function(scope), op_cost.scope(scope):
                run(state, mask)

        return scoped_run

    # ------------------------------------------------------------------
    # The loop
    # ------------------------------------------------------------------

    def _pc_live(self, state: dict[str, Any]) -> torch.Tensor:
        """``pc_top`` with every lane that no longer dispatches at
        ``exit_index``: halted lanes hold it already, and under
        ``"quarantine"`` faulted lanes are moved there too."""
        pc = state["pc_top"]
        if self.config.on_fault == "quarantine":
            pc = torch.where(state["fault_code"] == FAULT_OK, pc, self.lowered.exit_index)
        return pc

    def _fail_fast(self) -> bool:
        """Whether a non-finite or watchdog fault stops the loop: under
        ``"raise"`` with a detector on, it is fatal to the batch anyway."""
        cfg = self.config
        return cfg.on_fault == "raise" and (
            cfg.detect_nonfinite or cfg.lane_step_budget is not None)

    def _mask(self, state: dict[str, Any], b: int) -> torch.Tensor:
        """The lanes block ``b`` runs over: those resting there, less the
        quarantined ones."""
        mask = state["pc_top"] == b
        if self.config.on_fault == "quarantine":
            mask = mask & (state["fault_code"] == FAULT_OK)
        return mask

    def pick(self, state: dict[str, Any]) -> int:
        """The schedule's block (``exit_index`` once no lane dispatches);
        the value read back is the one host synchronisation of a dispatch.

        Lanes that do not dispatch count as resting at ``exit_index``
        (:meth:`_pc_live`), so ``earliest`` is the minimum over all lanes
        and the per-block counts of the others see only live lanes.  When a
        fault stops the loop (:meth:`_fail_fast`) the same read returns
        ``exit_index``.  ``argmax`` takes the first maximum, as
        ``jnp.argmax`` does.  Under a mesh the same choice is made on the
        host from the counts summed over the ranks (:meth:`_global_counts`)."""
        schedule, exit_idx = self.config.schedule, self.lowered.exit_index
        if schedule not in ("earliest", "popular", "lookahead"):
            raise ValueError(f"schedule {schedule!r} picks no block")
        if self.mesh is not None:
            counts, stop = self._global_counts(state)
            if stop or not counts.any():
                return exit_idx
            if schedule == "earliest":
                return int(np.flatnonzero(counts)[0])
            score = counts
            if schedule == "lookahead":
                score = np.where(counts > 0, 2 * counts + self._succ_host @ counts, -1)
            return int(np.argmax(score))
        return int(self._pick_index(state))

    def _pick_index(self, state: dict[str, Any]) -> torch.Tensor:
        """:meth:`pick`'s choice on the device, unsharded (not read back)."""
        schedule, pc = self.config.schedule, self._pc_live(state)
        exit_idx = self.lowered.exit_index
        if schedule == "earliest":
            b = pc.min()
        else:
            counts = (pc.unsqueeze(0) == self._block_ids).sum(dim=1)  # int64 [B]
            score = counts
            if schedule == "lookahead":
                score = 2 * counts + (self._succ * counts).sum(dim=1)
                score = torch.where(counts > 0, score, -1)
            b = torch.where(counts.sum() > 0, score.argmax(), exit_idx)
        if self._fail_fast():
            b = torch.where((state["fault_code"] >= FAULT_NONFINITE).any(), exit_idx, b)
        return b

    def _global_counts(self, state: dict[str, Any]) -> tuple[np.ndarray, bool]:
        """Under a mesh: the live lanes resting at each block, summed over
        the ranks, and whether a fault stops the loop anywhere — one int64
        all-reduce.  The residents of each block in this rank's last sweep
        ride along and bump the host's ``block_exec`` where any rank had
        some."""
        nb = self.num_blocks
        parts = [(self._pc_live(state).unsqueeze(0) == self._block_ids).sum(dim=1)]
        if self._fail_fast():
            parts.append((state["fault_code"] >= FAULT_NONFINITE).sum().view(1))
        pending = state.pop("sweep_active", None)
        if pending is not None:
            parts.append(pending.to(torch.int64))
        total = self._all_reduce(torch.cat(parts))
        if pending is not None:
            state["block_exec"] += (total[-nb:] > 0).astype(np.int32)
        return total[:nb], self._fail_fast() and bool(total[nb])

    def live(self, state: dict[str, Any]) -> bool:
        """Whether any lane still dispatches (one host read); False once a
        fault stops the loop."""
        if self.mesh is not None:
            counts, stop = self._global_counts(state)
            return bool(counts.any()) and not stop
        alive = (self._pc_live(state) < self.lowered.exit_index).any()
        if self._fail_fast():
            alive = alive & ~(state["fault_code"] >= FAULT_NONFINITE).any()
        return bool(alive)

    def dispatch(self, state: dict[str, Any], b: int) -> None:
        """One loop iteration of a switch schedule: run block ``b`` over
        the lanes resting there (in place), then compact when due."""
        mask = self._mask(state, b)
        active = tile = None
        if self.config.collect_block_stats:
            active = mask.sum(dtype=_I32)
            tile = tile_capacity(mask, self._tile_caps)
            state["block_exec"][b] += 1
            state["block_active"][b] += active
            state["tile_acc"] += tile
        if self.trace_capacity is not None:
            self._trace_event(state, b, mask, active, tile)
        self._block_fns[b](state, mask)
        self._end_iteration(state)

    def sweep(self, state: dict[str, Any]) -> None:
        """One loop iteration of ``"sweep"``: every block once, in index
        order, each under the mask of the lanes resting there when its
        turn comes; a block counts in ``block_exec`` only when it had
        residents (all on the device)."""
        collect = self.config.collect_block_stats
        if self.trace_capacity is not None:
            # One event a sweep: no single block runs, and every live
            # lane is dispatchable.
            live = self._pc_live(state) < self.lowered.exit_index
            self._trace_event(state, self.lowered.exit_index, live, None, None)
        active = []
        for b, fn in enumerate(self._block_fns):
            mask = self._mask(state, b)
            if collect:
                active.append(mask.sum(dtype=_I32))
                state["tile_acc"] += tile_capacity(mask, self._tile_caps)
            fn(state, mask)
        if collect:
            active = torch.stack(active)
            state["block_active"] += active
            if self.mesh is None:
                state["block_exec"] += (active > 0).to(_I32)
            else:
                # Counted from the ranks' sum at the next reduction.
                state["sweep_active"] = active
        self._end_iteration(state)

    def _trace_event(self, state: dict[str, Any], b: int, mask: torch.Tensor,
                     active: Optional[torch.Tensor], tile: Optional[torch.Tensor]) -> None:
        """Write the event of the loop iteration about to run into its ring
        row (slot ``steps % capacity``), all on the device: the residents,
        live and quarantined lanes before it, the ``mask``'s active lanes
        and tile capacity (``active``/``tile`` when the statistics already
        hold them), the block ``b`` (``exit_index``: a sweep) and whether
        compaction follows.  :meth:`_end_iteration` adds the faults."""
        row = state["trace"][state["steps"] % self.trace_capacity]
        counts = (self._pc_live(state).unsqueeze(0) == self._block_ids).sum(dim=1, dtype=_I32)
        if active is None:
            active = mask.sum(dtype=_I32)
            tile = tile_capacity(mask, self._tile_caps)
        k = self.config.compact_every
        compacted = k is not None and (state["steps"] + 1) % k == 0
        torch.cat([
            self._trace_block[b], active.view(1), counts.sum(dtype=_I32).view(1),
            (state["fault_code"] != FAULT_OK).sum(dtype=_I32).view(1), tile.view(1),
            self._trace_flag[int(compacted)], self._trace_flag[0], counts,
        ], out=row)

    def _end_iteration(self, state: dict[str, Any]) -> None:
        if self.trace_capacity is not None:
            # The event's faults: lanes faulted after the dispatch.
            row = state["trace"][state["steps"] % self.trace_capacity]
            torch.sum(state["fault_code"] != FAULT_OK, dim=0, dtype=_I32,
                      out=row[_FAULTS_COL])
        state["steps"] += 1
        k = self.config.compact_every
        if k is not None and state["steps"] % k == 0:
            self._compact(state)

    def _compact(self, state: dict[str, Any]) -> None:
        """Permute the lane axis of the whole state (in the dict) by a
        stable argsort on ``(liveness, pc_top)``; every permuted tensor is
        a fresh contiguous one."""
        pc = self._pc_live(state)
        key = torch.where(pc < self.lowered.exit_index, pc, self.num_blocks + 1)
        perm = torch.argsort(key, stable=True)
        for k in ("pc_top", "pc_ptr", "depth_exceeded", "fault_code", "lane_steps",
                  "lane_ids"):
            state[k] = state[k].index_select(0, perm)
        state["pc_stack"] = state["pc_stack"].index_select(1, perm)
        for group, dim in (("tops", 0), ("ptrs", 0), ("stacks", 1)):
            d = state[group]
            for v in d:
                d[v] = d[v].index_select(dim, perm)

    def unpermute(self, state: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        """A row-order ``[batch, ...]`` tensor in caller lane order (a fresh
        tensor: inject and park write the state in place)."""
        if self.config.compact_every is None:
            return x.clone()
        return x.index_select(0, torch.argsort(state["lane_ids"]))

    def _rows(self, state: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        """A whole-batch caller-order ``[batch, ...]`` tensor (a mask, fresh
        inputs) as this rank's lanes in the state's row order."""
        x = self._local(x)
        if self.config.compact_every is None:
            return x
        return x.index_select(0, state["lane_ids"] - self.lane_offset)

    def _loop(self, state: dict[str, Any], limit: int) -> None:
        """The host loop: iterate until no lane dispatches or ``steps``
        reaches ``limit``."""
        exit_idx = self.lowered.exit_index
        sweep = self.config.schedule == "sweep"
        while state["steps"] < limit:
            if sweep:
                if not self.live(state):
                    break
                self.sweep(state)
                continue
            b = self.pick(state)
            if b >= exit_idx:
                break
            self.dispatch(state, b)

    def step_fn(self) -> Callable:
        """One VM step as a function of the state, ``step(state) -> state``
        (the JAX VM's ``step_fn``).

        It honours ``config.schedule``: under a switch schedule it runs the
        one block :meth:`pick` chooses (its one host read; nothing once no
        lane dispatches), under ``"sweep"`` every block once, in index
        order, each under its own mask.  A step is one iteration of
        :meth:`run`'s loop — ``steps``, the statistics, the trace ring and
        compaction included — and updates ``state`` in place, as the
        blocks do; iterating it while :meth:`live` holds gives :meth:`run`'s
        state bit for bit."""
        if self.config.schedule == "sweep":
            def step(state: dict[str, Any]) -> dict[str, Any]:
                self.sweep(state)
                return state
        else:
            def step(state: dict[str, Any]) -> dict[str, Any]:
                b = self.pick(state)
                if b < self.lowered.exit_index:
                    self.dispatch(state, b)
                return state
        return step

    def cost_pass(self, state: dict[str, Any]) -> None:
        """What XLA's ``cost_analysis()`` counts of the JAX VM's loop, each
        computation once: the pick (under ``"sweep"``, the liveness test;
        under a mesh, this rank's counts that the ranks sum) and then every
        block body once, each under its own mask.  For an op counter over a
        fake state (:meth:`AotLowered.cost_analysis`); updates ``state`` in
        place."""
        if self.config.schedule == "sweep":
            (self._pc_live(state) < self.lowered.exit_index).any()
        elif self.mesh is not None:
            (self._pc_live(state).unsqueeze(0) == self._block_ids).sum(dim=1)
        else:
            self._pick_index(state)
        for b, fn in enumerate(self._block_fns):
            fn(state, self._mask(state, b))

    def run(self, inputs: dict[str, torch.Tensor]) -> VMResult:
        """Execute the batched program to completion (or ``max_steps``)."""
        state = self.init_state(inputs)
        self._loop(state, self.config.max_steps)
        return self.result(state)

    # ------------------------------------------------------------------
    # Segments
    # ------------------------------------------------------------------

    def run_segment(self, state: dict[str, Any], num_steps: int) -> dict[str, Any]:
        """Advance ``state`` (in place) by at most ``num_steps`` loop
        iterations — dispatches, or sweeps under ``"sweep"`` — and return
        it.  The loop is :meth:`run`'s, bounded by ``min(steps + num_steps,
        max_steps)``, so a chain of segments of any sizes is bit-exact with
        one run."""
        self._loop(state, min(state["steps"] + int(num_steps), self.config.max_steps))
        return state

    # The state's per-lane tensors: [batch, ...] rows, and [depth, batch,
    # ...] stacks with the lane on dim 1.
    _LANE_ROWS = ("pc_top", "pc_ptr", "depth_exceeded", "lane_steps", "fault_code", "lane_ids")

    def _map_lanes(self, state: dict[str, Any], fn) -> dict[str, Any]:
        """A shallow copy of ``state`` with ``fn(x, lane_dim)`` applied to
        each per-lane tensor; the other entries are kept."""
        out = dict(state)
        for k in self._LANE_ROWS:
            if k in state:
                out[k] = fn(state[k], 0)
        out["pc_stack"] = fn(state["pc_stack"], 1)
        for group, dim in (("tops", 0), ("ptrs", 0), ("stacks", 1)):
            out[group] = {v: fn(x, dim) for v, x in state[group].items()}
        return out

    def _in_caller_order(self, state: dict[str, Any], first: int) -> dict[str, Any]:
        """``state``'s rows in caller lane order, ``lane_ids`` from ``first``."""
        if "lane_ids" not in state:
            return state
        perm = torch.argsort(state["lane_ids"].to(self.device))
        out = self._map_lanes(state, lambda x, d: x.index_select(d, perm.to(x.device)))
        out["lane_ids"] = torch.arange(first, first + len(perm), dtype=_I32, device=self.device)
        return out

    def gather_state(self, state: dict[str, Any]) -> dict[str, Any]:
        """The whole batch's state in caller lane order: the layout an
        unsharded VM holds, so it snapshots in the unsharded format.  Under
        a mesh every rank calls it (the lanes gather over the host group)
        and gets every lane on the host; the other entries are this rank's."""
        state = self._in_caller_order(state, self.lane_offset)
        if self.mesh is None:
            return state
        out = self._map_lanes(state, lambda x, d: distributed.host_lanes(self._sharded(x, d)))
        if "lane_ids" in out:
            out["lane_ids"] = torch.arange(self.config.batch_size, dtype=_I32)
        return out

    def shard_state(self, state: dict[str, Any]) -> dict[str, Any]:
        """This rank's lanes of a whole-batch state (:meth:`gather_state`'s
        layout, or an unsharded VM's in any row order), on the device."""
        state = self._in_caller_order(state, 0)
        lo, n = self.lane_offset, self.lanes
        out = self._map_lanes(state, lambda x, d: x.narrow(d, lo, n).to(self.device).contiguous())
        if "lane_ids" in out:
            out["lane_ids"] = out["lane_ids"] + lo
        for k, x in out.items():
            if isinstance(x, torch.Tensor) and k not in self._LANE_ROWS and k != "pc_stack":
                out[k] = x.to(self.device)
        return out

    def lanes_of(self, state: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        """A row-order per-lane tensor of the state as the caller's
        ``[batch, ...]`` (:meth:`unpermute`; a lane-sharded ``DTensor``
        under a mesh)."""
        return self._sharded(self.unpermute(state, x))

    def lane_done(self, state: dict[str, Any]) -> torch.Tensor:
        """``[batch]`` bool, caller order: lanes at the exit block."""
        return self.lanes_of(state, state["pc_top"] >= self.lowered.exit_index)

    def lane_fault(self, state: dict[str, Any]) -> torch.Tensor:
        """``[batch]`` int32 fault codes, caller order (:data:`FAULT_NAMES`)."""
        return self.lanes_of(state, state["fault_code"])

    def lane_faulted(self, state: dict[str, Any]) -> torch.Tensor:
        """``[batch]`` bool, caller order: lanes that faulted."""
        return self.lanes_of(state, state["fault_code"] != FAULT_OK)

    def lane_depth_exceeded(self, state: dict[str, Any]) -> torch.Tensor:
        """``[batch]`` bool, caller order: lanes whose stacks overflowed."""
        return self.lanes_of(state, state["depth_exceeded"])

    def lane_status(self, state: dict[str, Any]) -> torch.Tensor:
        """``[2, batch]`` int32, caller order: the halt flags and the fault
        codes in one tensor, so a host loop reads both in one transfer
        (under a mesh, sharded along dim 1)."""
        done = (state["pc_top"] >= self.lowered.exit_index).to(_I32)
        both = self.unpermute(state, torch.stack([done, state["fault_code"]], dim=1)).T
        return self._sharded(both.contiguous(), dim=1)

    def park(self, state: dict[str, Any], mask) -> dict[str, Any]:
        """Send the masked lanes (``[batch]`` bool, caller order, the whole
        batch) to the exit block, in place: they idle until :meth:`inject`
        refills them."""
        mask = self._rows(state, torch.as_tensor(mask, dtype=torch.bool).to(self.device))
        state["pc_top"].masked_fill_(mask, self.lowered.exit_index)
        return state

    def inject(self, state: dict[str, Any], mask,
               inputs: dict[str, torch.Tensor]) -> dict[str, Any]:
        """Re-initialize the masked lanes (``[batch]`` bool, caller order)
        with fresh inputs (full ``[batch, ...]`` tensors; unmasked rows are
        ignored), in place: each masked lane gets exactly what
        :meth:`init_state` gives it — pc, pc stack and pointer, variable
        stacks, pointers and tops, overflow flag, fault code and step count.
        Unmasked lanes and the global counters are untouched."""
        lp, z = self.lowered, self.config.batch_size  # whole-batch arguments
        fresh = {}
        for p in lp.main_params:
            spec = lp.var_specs[p]
            x = torch.as_tensor(inputs[p])
            if tuple(x.shape) != (z,) + spec.shape:
                raise ValueError(
                    f"inject input {p!r}: expected batched shape "
                    f"{(z,) + spec.shape}, got {tuple(x.shape)}"
                )
            fresh[p] = self._rows(state, x.to(device=self.device, dtype=spec.dtype))
        mask = self._rows(state, torch.as_tensor(mask, dtype=torch.bool).to(self.device))
        state["pc_top"].masked_fill_(mask, lp.entry)
        state["pc_ptr"].masked_fill_(mask, 1)
        state["pc_stack"].masked_fill_(mask.unsqueeze(0), lp.exit_index)
        for k in ("depth_exceeded", "fault_code", "lane_steps"):
            state[k].masked_fill_(mask, 0)
        tops = state["tops"]
        for top in tops.values():
            top.masked_fill_(_bcast(mask, top), 0)
        for p, x in fresh.items():
            top = self.read_top(state, p)  # a packed member: its slot
            top.copy_(_masked(mask, x, top))
        for v, stack in state["stacks"].items():
            stack.masked_fill_(_bcast(mask, stack[0]).unsqueeze(0), 0)
        for ptr in state["ptrs"].values():
            ptr.masked_fill_(mask, 0)
        return state

    def result(self, state: dict[str, Any]) -> VMResult:
        """A :class:`VMResult` of any state (per-lane tensors in caller
        order); ``converged`` says whether every lane halted (or, under
        ``"quarantine"``, halted or faulted).  Under a mesh the counters
        are summed over the ranks here (a collective) and the per-lane
        tensors are lane-sharded ``DTensor``s."""
        lp, cfg = self.lowered, self.config
        be = ba = None
        tag_stats: dict[str, tuple[int, int]] = {}
        steps = masked_updates = None
        occ = lane_occ = float("nan")
        done = state["pc_top"] >= lp.exit_index
        if cfg.on_fault == "quarantine":
            done = done | (state["fault_code"] != FAULT_OK)
        undone = (~done).sum(dtype=torch.int64).view(1)
        if self.mesh is not None:
            # One reduction: [block_active, tile_acc, a last sweep's
            # residents] when collected, then the lanes not done.
            parts = []
            if cfg.collect_block_stats:
                parts = [state["block_active"].to(torch.int64),
                         state["tile_acc"].to(torch.int64).view(1)]
                pending = state.pop("sweep_active", None)
                if pending is not None:
                    parts.append(pending.to(torch.int64))
            total = self._all_reduce(torch.cat(parts + [undone]))
            converged = not total[-1]
            if cfg.collect_block_stats:
                nb = self.num_blocks
                if pending is not None:
                    state["block_exec"] += (total[nb + 1:2 * nb + 1] > 0).astype(np.int32)
                ba, tile = total[:nb].astype(np.int32), int(total[nb])
        else:
            converged = not bool(undone)
            if cfg.collect_block_stats:
                ba, tile = state["block_active"].cpu().numpy(), int(state["tile_acc"])
        if cfg.collect_block_stats:
            be = state["block_exec"]
            be = be.cpu().numpy() if isinstance(be, torch.Tensor) else be.copy()
            tag_stats = {
                tag: (
                    sum(int(be[b]) * m for b, m in entries),
                    sum(int(ba[b]) * m for b, m in entries),
                )
                for tag, entries in self._tag_blocks.items()
            }
            dispatches, active = int(be.sum()), float(ba.sum())
            if dispatches:
                lane_occ = active / (dispatches * cfg.batch_size)
            if tile:
                occ = active / tile
            steps = state["steps"]
            masked_updates = sum(int(be[b]) * w for b, w in enumerate(self._masked_writes))
        sched = SchedulerStats(
            schedule=cfg.schedule, fused=lp.fused_from is not None,
            num_blocks=self.num_blocks, steps=steps, mean_occupancy=occ,
            fused_from=lp.fused_from, num_devices=self.num_devices,
            mean_lane_occupancy=lane_occ, compact_every=cfg.compact_every,
            masked_updates=masked_updates,
        )
        return VMResult(
            outputs={o: self.lanes_of(state, self.read_top(state, o)) for o in lp.main_outputs},
            steps=state["steps"],
            converged=converged,
            block_exec=be,
            block_active=ba,
            tag_stats=tag_stats,
            depth_exceeded=self.lane_depth_exceeded(state),
            lane_steps=self.lanes_of(state, state["lane_steps"]),
            sched=sched,
            fault_code=self.lane_fault(state),
            trace=self.get_trace(state),
        )

    def get_trace(self, state: dict[str, Any]):
        """Drain the dispatch-trace ring of any state into a
        :class:`repro_torch.obs.trace.DispatchTrace` (oldest surviving
        event first; one host read), or None without ``trace``.  The ring
        is not consumed: a later drain sees these events and newer ones.
        Under a mesh the lane counts are summed over the ranks (a
        collective); the block and compaction columns are every rank's."""
        if self.trace_capacity is None:
            return None
        ring = state["trace"].cpu()
        if self.mesh is not None:
            total = distributed.all_reduce_sum(self.mesh, ring.clone())
            for col in _RANK_INVARIANT_COLS:
                total[:, col] = ring[:, col]
            ring = total
        ring = ring.numpy()
        buffers = {name: ring[:, i] for i, name in enumerate(TRACE_COLUMNS)}
        buffers["resident"] = ring[:, len(TRACE_COLUMNS):]
        return obs_trace.drain(
            buffers, total=state["steps"], schedule=self.config.schedule,
            num_blocks=self.num_blocks, batch_size=self.config.batch_size,
        )

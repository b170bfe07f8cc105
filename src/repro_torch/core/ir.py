"""Control-flow-graph IR for autobatching (paper Fig. 2) and its lowered,
stack-explicit form (paper Fig. 4), on PyTorch types.

Source IR (``Program``/``Function``/``Block``): per-function CFGs whose ops
are ``Prim`` (pure per-member computations) and ``Call`` (possibly-recursive
calls to other autobatched functions), and whose terminators are ``Jump``,
``Branch`` and ``Return``.

Lowered IR (``LoweredProgram``): all function CFGs merged into one block
list; ``Call`` is replaced by explicit per-variable stack manipulation
(``LPush``/``LPop``) plus ``LPushJump``/``LReturn`` for the program counter,
exactly as in the paper's Figure 4.  Variable names are qualified as
``"<function>/<var>"`` so namespaces never collide across functions.

Types are :class:`Spec` — a per-member ``(shape, torch.dtype)`` pair.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch


@dataclass(frozen=True)
class Spec:
    """Shape and dtype of one batch member's value (no batch axis)."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))


# --------------------------------------------------------------------------
# Source IR (paper Fig. 2)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Prim:
    """``outs = fn(*ins)`` — a pure, per-batch-member computation.

    ``fn`` consumes/produces *unbatched* tensors; the runtimes batch it with
    ``torch.func.vmap`` unless ``batched=True``, in which case ``fn`` is
    expected to handle a leading batch dimension itself.
    """

    outs: tuple[str, ...]
    fn: Callable[..., Any]
    ins: tuple[str, ...]
    name: str = "prim"
    batched: bool = False
    # Tag used by instrumentation (e.g. counting gradient evaluations).
    tag: Optional[str] = None


@dataclass(frozen=True)
class Call:
    """``outs = callee(*ins)`` — call to another autobatched function."""

    outs: tuple[str, ...]
    callee: str
    ins: tuple[str, ...]


@dataclass(frozen=True)
class Jump:
    target: int


@dataclass(frozen=True)
class Branch:
    """Two-way branch on a per-member boolean variable."""

    var: str
    true: int
    false: int


@dataclass(frozen=True)
class Return:
    pass


Terminator = Jump | Branch | Return
Op = Prim | Call


@dataclass
class Block:
    ops: list[Op] = field(default_factory=list)
    term: Optional[Terminator] = None
    label: str = ""


@dataclass(frozen=True)
class ArgBinding:
    """How one positional pytree argument binds to IR parameters.

    ``params`` are the IR parameter names consumed by the argument's leaves,
    in pytree flatten order (:mod:`.tree`, JAX's order); ``treedef`` is the
    argument's structure.  ``shared`` arguments carry no batch axis at call
    time; the caller broadcasts them across the batch.
    """

    params: tuple[str, ...]
    treedef: Any
    shared: bool = False


@dataclass(frozen=True)
class Interface:
    """Pytree calling convention of a function (recorded by the public API).

    ``args`` maps positional pytree arguments onto flat IR parameters;
    ``out_treedef``/``out_leaves`` describe how the flat IR outputs are
    reassembled into the result pytree.
    """

    args: tuple[ArgBinding, ...]
    out_treedef: Any
    out_leaves: tuple[str, ...]


@dataclass
class Function:
    """A function in the source IR.

    ``param_specs`` / ``output_specs`` are :class:`Spec` per *batch member*
    (no batch dimension).  Output specs must be declared because recursive
    functions cannot have their output types inferred by a simple forward
    pass; everything else is inferred (see analysis.infer_types).

    ``iface``, when present, records the pytree calling convention the
    public :mod:`.batching` API uses to flatten positional pytree arguments
    into ``params`` and unflatten ``outputs`` into a result tree.
    """

    name: str
    params: tuple[str, ...]
    outputs: tuple[str, ...]
    blocks: list[Block] = field(default_factory=list)
    param_specs: dict[str, Spec] = field(default_factory=dict)
    output_specs: dict[str, Spec] = field(default_factory=dict)
    # Filled by type inference: spec for every local variable.
    var_specs: dict[str, Spec] = field(default_factory=dict)
    # Optional pytree calling convention (see Interface).
    iface: Optional[Interface] = None

    def validate(self) -> None:
        for i, blk in enumerate(self.blocks):
            if blk.term is None:
                raise ValueError(f"{self.name}: block {i} has no terminator")
            for tgt in _targets(blk.term):
                if not (0 <= tgt < len(self.blocks)):
                    raise ValueError(
                        f"{self.name}: block {i} jumps to out-of-range {tgt}"
                    )
        for p in self.params:
            if p not in self.param_specs:
                raise ValueError(f"{self.name}: missing param spec for {p!r}")
        for o in self.outputs:
            if o not in self.output_specs:
                raise ValueError(f"{self.name}: missing output spec for {o!r}")


@dataclass
class Program:
    functions: dict[str, Function]
    main: str

    def validate(self) -> None:
        if self.main not in self.functions:
            raise ValueError(f"main function {self.main!r} not defined")
        for fn in self.functions.values():
            fn.validate()
            for blk in fn.blocks:
                for op in blk.ops:
                    if isinstance(op, Call) and op.callee not in self.functions:
                        raise ValueError(
                            f"{fn.name}: call to undefined function {op.callee!r}"
                        )


def _targets(term: Terminator) -> tuple[int, ...]:
    if isinstance(term, Jump):
        return (term.target,)
    if isinstance(term, Branch):
        return (term.true, term.false)
    return ()


def successors(blocks: list[Block], i: int) -> tuple[int, ...]:
    return _targets(blocks[i].term)


# --------------------------------------------------------------------------
# Lowered IR (paper Fig. 4)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class LPrim:
    """Masked in-place update of the tops of ``outs`` (paper's ``Update``)."""

    outs: tuple[str, ...]
    fn: Callable[..., Any]
    ins: tuple[str, ...]
    name: str = "prim"
    batched: bool = False
    tag: Optional[str] = None


@dataclass(frozen=True)
class LPush:
    """Bury the current top of ``var`` and set the new top to ``src``'s top.

    With ``src == var`` this duplicates the top (a caller-save).  With
    ``src != var`` it is argument passing into a recursive frame.
    """

    var: str
    src: str


@dataclass(frozen=True)
class LPop:
    """Restore ``var``'s top from its stack."""

    var: str


@dataclass(frozen=True)
class LJump:
    target: int


@dataclass(frozen=True)
class LBranch:
    var: str
    true: int
    false: int


@dataclass(frozen=True)
class LPushJump:
    """Enter a function body: bury ``ret`` on the pc stack, jump to ``target``.

    Algorithm 2: ``Set pc_top = ret; PUSH target onto pc``.
    """

    target: int
    ret: int


@dataclass(frozen=True)
class LReturn:
    """Pop the pc stack (control resumes at the buried return address)."""


LTerminator = LJump | LBranch | LPushJump | LReturn
LOp = LPrim | LPush | LPop


@dataclass
class LBlock:
    ops: list[LOp] = field(default_factory=list)
    term: Optional[LTerminator] = None
    label: str = ""


@dataclass(frozen=True)
class StateLayout:
    """Packed VM-state layout produced by ``StateLayoutPacking``.

    ``groups`` maps each packed array variable (a synthetic
    ``%pgo/pack<N>`` name with spec ``(k,) + member_shape``) to its member
    variables in slot order.  A member's top lives at ``tops[packed][:, slot]``
    instead of its own ``tops[member]`` buffer; inside a block the members
    are materialized by an ``unpack`` prim and written back by a single
    ``pack`` prim, so every boundary surface (inject/park/outputs/stepper,
    stack kernels) reads and writes through this mapping.
    """

    groups: dict[str, tuple[str, ...]]

    def members(self) -> frozenset[str]:
        return frozenset(m for ms in self.groups.values() for m in ms)

    def slot_of(self, var: str) -> Optional[tuple[str, int]]:
        """``(packed_var, slot)`` for a member, else ``None``."""
        for packed, ms in self.groups.items():
            if var in ms:
                return packed, ms.index(var)
        return None


@dataclass
class LoweredProgram:
    """The merged, stack-explicit program that the PC VM executes."""

    blocks: list[LBlock]
    entry: int
    main_params: tuple[str, ...]  # qualified names
    main_outputs: tuple[str, ...]  # qualified names
    var_specs: dict[str, Spec]
    stack_vars: frozenset[str]  # vars that need a stack (paper opt. iii)
    temp_vars: frozenset[str]  # block-local temporaries (paper opt. ii)
    func_entries: dict[str, int]  # function name -> entry block index
    # Superblock-fusion provenance (fusion.py): new block index -> the
    # original (pre-fusion) block indices whose ops it concatenates, in
    # execution order.  ``None`` when the program was never fused.
    fused_from: Optional[dict[int, tuple[int, ...]]] = None
    # Profile-guided-optimization provenance.  ``block_weights[i]`` is the
    # profile-estimated dispatch count of block ``i`` (seeded by
    # ``ProfileGuidedFusion`` from a ``BlockProfile`` and propagated through
    # every renumbering pass); ``None`` when the program is unprofiled.
    block_weights: Optional[tuple[int, ...]] = None
    # ``BlockReordering`` permutation: ``block_order[new] = old`` index in
    # the program that pass consumed.  ``None`` when never reordered.
    block_order: Optional[tuple[int, ...]] = None
    # Packed-state layout recorded by ``StateLayoutPacking`` (see
    # :class:`StateLayout`); ``None`` when state is unpacked.
    state_layout: Optional[StateLayout] = None
    # Where type inference typed the primitives (the tensors they close
    # over live there); the verifier types them on fake tensors of it.
    device: Optional[torch.device] = None

    @property
    def exit_index(self) -> int:
        """Sentinel pc value meaning "this member has halted"."""
        return len(self.blocks)

    def var_class(self, var: str) -> str:
        """``"stack"`` (has a stack + pointer), ``"temp"`` (block-local,
        never enters VM state) or ``"state"`` (masked top buffer only)."""
        if var in self.stack_vars:
            return "stack"
        if var in self.temp_vars:
            return "temp"
        return "state"

    def pretty(self) -> str:
        lines = []
        rev_entries = {v: k for k, v in self.func_entries.items()}
        if self.block_order is not None:
            perm = ",".join(str(o) for o in self.block_order)
            lines.append(f"reordered: [{perm}]   <new index -> old index>")
        if self.state_layout is not None:
            for packed, members in self.state_layout.groups.items():
                lines.append(
                    f"layout {packed}: [{', '.join(members)}]"
                )
        for i, blk in enumerate(self.blocks):
            hdr = f"[{i}] {blk.label}"
            if i in rev_entries:
                hdr += f"   <entry of {rev_entries[i]}>"
            if self.fused_from is not None and i in self.fused_from:
                srcs = ",".join(str(s) for s in self.fused_from[i])
                hdr += f"   <fused from {srcs}>"
            if self.block_weights is not None:
                hdr += f"   <weight {self.block_weights[i]}>"
            lines.append(hdr)
            for op in blk.ops:
                if isinstance(op, LPrim):
                    lines.append(
                        f"    {', '.join(op.outs)} = {op.name}({', '.join(op.ins)})"
                    )
                elif isinstance(op, LPush):
                    lines.append(f"    push {op.var} <- {op.src}")
                elif isinstance(op, LPop):
                    lines.append(f"    pop  {op.var}")
            t = blk.term
            if isinstance(t, LJump):
                lines.append(f"    jump {t.target}")
            elif isinstance(t, LBranch):
                lines.append(f"    branch {t.var} ? {t.true} : {t.false}")
            elif isinstance(t, LPushJump):
                lines.append(f"    pushjump {t.target} (ret {t.ret})")
            elif isinstance(t, LReturn):
                lines.append("    return")
        lines.append("vars:")
        for v in sorted(self.var_specs):
            spec = self.var_specs[v]
            lines.append(
                f"    {v}: {self.var_class(v)} {spec.shape} {spec.dtype}"
            )
        return "\n".join(lines)


def qualify(func: str, var: str) -> str:
    return f"{func}/{var}"


def prim_reads(op: LOp) -> tuple[str, ...]:
    if isinstance(op, LPrim):
        return op.ins
    if isinstance(op, LPush):
        return (op.src,)
    return ()


def prim_writes(op: LOp) -> tuple[str, ...]:
    if isinstance(op, LPrim):
        return op.outs
    if isinstance(op, (LPush, LPop)):
        return (op.var,)
    return ()


def identity(x):
    """The copy primitive's function; the VM moves its input unbatched."""
    return x


def identity_prim(out: str, src: str, name: str = "copy") -> LPrim:
    return LPrim(outs=(out,), fn=identity, ins=(src,), name=name)


def dataclass_replace(obj, **kw):
    return dataclasses.replace(obj, **kw)

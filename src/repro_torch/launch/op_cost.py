"""Op-level cost counter: the FLOPs, HBM bytes, collectives and peak memory
of eager PyTorch code, per device (the port's counterpart of the JAX
package's ``launch/hlo_cost.py``).

The reference counts on the HLO text of a compiled XLA program.  The port
compiles nothing: an eager step *is* the sequence of ATen ops it
dispatches, so :class:`OpCounter`, a ``TorchDispatchMode``, counts them as
they dispatch, on real tensors or on fake ones (:mod:`repro_torch.fake`),
where nothing is computed or allocated.  Per op:

* **FLOPs**: ``2 * prod(result) * prod(contraction)`` for every matrix
  product (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``;
  ``einsum``, ``matmul`` and ``linear`` reach the dispatcher as these) and
  ``2 * prod(result) * (C_in / groups) * prod(kernel)`` for a convolution
  (its backward: the same for each gradient it makes).  Eager code runs
  every iteration of a Python loop, so a loop of 12 counts its body 12
  times.  A loop too long to run op by op on fake tensors (the sLSTM's
  scan over 32,768 tokens) runs one trip under :func:`trips`, as
  ``hlo_cost.py`` counts an XLA ``while`` loop's body times its trip
  count: the ops of that trip, and of its autograd nodes' backward, count
  ``n`` times, and the storages it leaves live count ``n`` times from
  :meth:`Trips.hold` until freed.
* **HBM bytes**: operand plus result bytes of every op (a broadcast
  operand counts its distinct elements).  Views and metadata ops count
  zero, and so does an allocation (``empty``).  Eager PyTorch fuses
  nothing, so this is the eager path's own traffic, and an upper bound
  against a fused step: XLA keeps a fusion's intermediates on chip, and
  ``hlo_cost.py`` counts only what crosses fusion boundaries.
* **Collectives**: each functional collective (``_c10d_functional``, which
  DTensor issues; DTensor's own ``shard_dim_alltoall``) and each ``c10d``
  collective, under the reference's kind names (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``; ``broadcast`` besides), as ``{count, bytes}`` with the result's bytes per
  device, as ``hlo_cost.py`` counts them; ``dims`` splits both by the mesh
  dim whose group the collective runs over (the group's name where no mesh
  given to the counter has it).
* **Scopes**: ops under :func:`scope` add their bytes and FLOPs to
  ``scope_bytes[name]`` / ``scope_flops[name]`` (the reference reads its
  ``jax.named_scope`` labels from each instruction's ``op_name``).  The
  backward of a scoped op counts in the scope too: the counter notes the
  autograd node a scoped op makes and attributes the ops run for that node
  (:func:`trips` marks its nodes the same way).
* **Kernels**: the port's kernels launch through ``ctypes``, where no mode
  sees them, and on a fake tensor they compute nothing.  Each kernel
  wrapper calls :func:`record` with its FLOPs (what its plain version's ops
  count) and its bytes, on a real launch and on a fake tensor alike; they
  add to the totals and to ``kernels[name] = {count, flops, bytes}``.
* **Peak memory**: the counter follows every storage an op makes (and the
  storages of :meth:`OpCounter.arguments`) until it is freed.
  ``peak_bytes`` is the most that were live at once; as XLA's
  ``memory_analysis()`` splits it, ``argument_bytes`` are the arguments',
  ``output_bytes`` those of :meth:`OpCounter.outputs` that are not
  arguments, and ``temp_bytes = peak_bytes - argument_bytes``.

Placement against DTensor: the counter counts what one rank runs, on its
local shards.  An op on DTensors returns ``NotImplemented`` here (as
``CommDebugMode`` does), so DTensor runs it and the counter sees the local
ops it issues and the collectives of its redistributions.  The ops that
DTensor's sharding propagation runs on global-shaped fake tensors, to learn
an output's shape, are no rank's work and are skipped.

Enter the counter inside a ``FakeTensorMode``, so that it sees each op
before the fake mode answers it.  Nothing here is private to PyTorch
beyond ``torch._C._current_autograd_node`` and the autograd sequence
number, which the scopes' and trips' backward attribution reads.
"""
from __future__ import annotations

import contextlib
import math
import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# Op name (without namespace) -> collective kind, for the functional and
# the c10d collectives.
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "shard_dim_alltoall": "all-to-all",  # DTensor's (namespace _dtensor)
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")

# Ops that move no data: metadata, aliases, allocations and waits.
_FREE_OPS = {
    "aten::detach", "aten::alias", "aten::_unsafe_view", "aten::lift_fresh",
    "aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty",
    "aten::new_empty_strided", "aten::set_", "aten::resize_", "aten::_local_scalar_dense",
    "aten::sym_size", "aten::sym_stride", "aten::sym_numel", "aten::sym_storage_offset",
    "aten::is_contiguous", "aten::is_same_size", "aten::_has_compatible_shallow_copy_type",
    "_c10d_functional::wait_tensor", "_c10d_functional::_wrap_tensor_autograd",
    "c10d_functional::wait_tensor",
}

_SHARDING_PROP = os.path.join("tensor", "_sharding_prop.py")

_ACTIVE: list["OpCounter"] = []


def active() -> Optional["OpCounter"]:
    """The innermost counter in force, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def record(name: str, *, flops: float, nbytes: float) -> None:
    """A kernel launch (or a kernel's answer to a fake tensor) of ``flops``
    FLOPs and ``nbytes`` HBM bytes, counted by the active counter under
    ``kernels[name]``; nothing when no counter is active."""
    c = active()
    if c is not None:
        c._record(name, float(flops), float(nbytes))


_NO_SCOPE = contextlib.nullcontext()


def scope(name: str):
    """Count the ops within (and their backward) under ``name`` too; with
    no counter active, a shared context that does nothing."""
    c = active()
    return _NO_SCOPE if c is None else _scope(c, name)


@contextlib.contextmanager
def _scope(c: "OpCounter", name: str):
    c._scopes.append(name)
    try:
        yield
    finally:
        c._scopes.pop()


@contextlib.contextmanager
def uncounted():
    """Count nothing within (aliases that stand for tensors a trip counted
    already); with no counter active, nothing happens."""
    c = active()
    if c is None:
        yield
    else:
        with c.paused():
            yield


class Trips:
    """One trip of a loop standing for ``n``: within ``with``, every op (and
    the backward of every autograd node made there) counts ``n`` times;
    :meth:`hold`, called once the loop is done, makes each storage the trip
    made that is still live count ``n`` times until it is freed, as the
    ``n`` trips' would be.  With no counter active it does nothing."""

    def __init__(self, counter: Optional["OpCounter"], n: int):
        self._counter, self.n = counter, n
        self._keys: set = set()

    def __enter__(self):
        if self._counter is not None:
            self._counter._trips.append(self)
            self._counter._unheld.append(self)
        return self

    def __exit__(self, *exc):
        if self._counter is not None:
            self._counter._trips.remove(self)

    def hold(self) -> None:
        if self._counter is not None and self in self._counter._unheld:
            self._counter._unheld.remove(self)
            self._counter._hold(self._keys, self.n)
        self._keys = set()


def trips(n: int) -> Trips:
    """A :class:`Trips` of ``n`` for the active counter."""
    return Trips(active(), n)


@dataclass
class Cost:
    """What a counter counted (per device).  ``collectives`` maps a kind to
    ``{"count", "bytes", "dims": {dim: {"count", "bytes"}}}``."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: dict = field(default_factory=dict)
    scope_bytes: dict = field(default_factory=dict)
    scope_flops: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)
    dot_count: int = 0
    op_count: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())


def _footprint(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a stride-0 dim counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def _flops(name: str, args: tuple, out) -> tuple[float, bool]:
    """``(flops, is a product)`` of one op."""
    if name in ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::addbmm",
                "aten::mv", "aten::addmv", "aten::dot", "aten::vdot"):
        a = args[1] if name in ("aten::addmm", "aten::baddbmm", "aten::addbmm",
                                "aten::addmv") else args[0]
        res = out if isinstance(out, torch.Tensor) else None
        k = a.shape[-1]
        if name == "aten::addbmm":  # sums over the batch too
            k *= a.shape[0]
        return 2.0 * (_numel(res.shape) if res is not None else 1) * k, True
    if name in ("aten::convolution", "aten::_convolution"):
        x, w, groups = args[0], args[1], args[8]
        return 2.0 * _numel(out.shape) * (x.shape[1] // groups) * _numel(w.shape[2:]), True
    if name == "aten::convolution_backward":
        grad_out, x, w = args[0], args[1], args[2]
        groups, mask = args[9], args[10]
        one = 2.0 * _numel(grad_out.shape) * (x.shape[1] // groups) * _numel(w.shape[2:])
        return one * (int(mask[0]) + int(mask[1])), True
    return 0.0, False


def _in_sharding_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_SHARDING_PROP):
            return True
        f = f.f_back
    return False


def _group_dims(meshes: Iterable) -> dict:
    """``{process group name: mesh dim name}`` of each mesh's dims."""
    out = {}
    for mesh in meshes:
        for d, dim in enumerate(mesh.mesh_dim_names or range(mesh.ndim)):
            out[mesh.get_group(d).group_name] = str(dim)
    return out


def _group_of(args: tuple, kwargs: dict) -> Optional[str]:
    """The group a collective runs over: a functional collective's last
    string argument, or a c10d collective's process group's name."""
    for x in reversed(list(args) + list(kwargs.values())):
        if isinstance(x, str):
            return x
        name = getattr(x, "group_name", None)
        if isinstance(name, str):
            return name
    return None


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is in force (see the module
    docstring); :meth:`close` gives the totals.  ``meshes`` name the dims
    of their groups' collectives."""

    def __init__(self, *, meshes: Iterable = ()):
        super().__init__()
        self._meshes = list(meshes)
        self._dims: Optional[dict] = None
        self._cost = Cost()
        self._scopes: list[str] = []
        self._scoped_nodes: dict[int, tuple] = {}
        self._trips: list[Trips] = []
        self._unheld: list[Trips] = []  # their storages' keys are followed until freed
        self._node_trips: dict[int, int] = {}
        self._live: dict[int, int] = {}
        self._live_bytes = 0
        self._args: set[int] = set()
        self._paused = False
        self._closed = False
        self._dtensor: Optional[type] = None
        self._dtensor_seen = False
        if torch.distributed.is_available():
            from torch.distributed.tensor import DTensor

            self._dtensor = DTensor

    # ------------------------------------------------------------ the mode

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused or not isinstance(func, torch._ops.OpOverload):
            return func(*args, **kwargs)
        if self._dtensor is not None and any(issubclass(t, self._dtensor) for t in types):
            self._note_scoped_node(args, kwargs)
            self._dtensor_seen = True
            return NotImplemented
        self._note_scoped_node(args, kwargs)
        out = func(*args, **kwargs)
        if self._dtensor_seen and _in_sharding_propagation():
            return out
        self._count(func, args, kwargs, out)
        return out

    # ------------------------------------------------------------ counting

    def _scope_names(self) -> set:
        names = set(self._scopes)
        if self._scoped_nodes:
            node = torch._C._current_autograd_node()
            if node is not None:
                names.update(self._scoped_nodes.get(node._sequence_nr(), ()))
        return names

    def _trip_count(self) -> int:
        """How many times an op counts here: the product of the trips in
        force and, in a backward pass, the trips of the node it runs for."""
        n = math.prod(t.n for t in self._trips)
        if self._node_trips:
            node = torch._C._current_autograd_node()
            if node is not None:
                n *= self._node_trips.get(node._sequence_nr(), 1)
        return n

    def _note_scoped_node(self, args: tuple, kwargs: dict) -> None:
        """Under a scope (or trips), the autograd node this op made (if it
        made one) is the scope's: its backward counts there (that many
        times)."""
        if not (self._scopes or self._trips) or not torch.is_grad_enabled():
            return
        if any(t.requires_grad for t in _tensors((args, kwargs))):
            seq = torch._C._autograd._get_sequence_nr() - 1
            if self._scopes:
                self._scoped_nodes[seq] = tuple(self._scopes)
            if self._trips:
                self._node_trips[seq] = math.prod(t.n for t in self._trips)

    def _add(self, flops: float, nbytes: float) -> None:
        c = self._cost
        n = self._trip_count()
        flops, nbytes = flops * n, nbytes * n
        c.flops += flops
        c.bytes_accessed += nbytes
        for name in self._scope_names():
            c.scope_bytes[name] = c.scope_bytes.get(name, 0.0) + nbytes
            c.scope_flops[name] = c.scope_flops.get(name, 0.0) + flops

    def _count(self, func, args: tuple, kwargs: dict, out) -> None:
        name = func._schema.name
        if name.startswith("prim::"):  # device and layout queries
            return
        c = self._cost
        c.op_count += self._trip_count()
        outs = _tensors(out)
        ns, _, op = name.partition("::")
        kind = _COLLECTIVE_OPS.get(op) if ns in _COLLECTIVE_NAMESPACES else None
        if kind is not None:
            self._collective(kind, args, kwargs, outs)
        if name in _FREE_OPS or func.is_view:
            nbytes = 0
        else:
            ins = {id(t): t for t in _tensors((args, kwargs))}
            nbytes = sum(_footprint(t) for t in ins.values()) + sum(_footprint(t) for t in outs)
        flops, product = _flops(name, args, out)
        c.dot_count += product * self._trip_count()
        self._add(flops, nbytes)
        for t in outs:
            self._track(t)

    def _collective(self, kind: str, args: tuple, kwargs: dict, outs: list) -> None:
        if self._dims is None:
            self._dims = _group_dims(self._meshes)
        group = _group_of(args, kwargs)
        dim = self._dims.get(group, group or "?")
        n = self._trip_count()
        nbytes = n * float(sum(t.numel() * t.element_size() for t in outs))
        e = self._cost.collectives.setdefault(kind, {"count": 0, "bytes": 0.0, "dims": {}})
        e["count"] += n
        e["bytes"] += nbytes
        d = e["dims"].setdefault(dim, {"count": 0, "bytes": 0.0})
        d["count"] += n
        d["bytes"] += nbytes

    def _record(self, name: str, flops: float, nbytes: float) -> None:
        n = self._trip_count()
        k = self._cost.kernels.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0.0})
        k["count"] += n
        k["flops"] += flops * n
        k["bytes"] += nbytes * n
        self._cost.dot_count += (flops > 0) * n
        self._add(flops, nbytes)

    # ------------------------------------------------------------ memory

    def _track(self, t: torch.Tensor) -> Optional[int]:
        """Follow ``t``'s storage until it is freed; its key."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):  # no storage (a wrapper)
            return None
        key = st._cdata
        if key not in self._live:
            self._live[key] = st.nbytes()
            self._grow(self._live[key])
            weakref.finalize(st, self._free, key)
            for trip in self._trips:
                trip._keys.add(key)
        return key

    def _grow(self, nbytes: int) -> None:
        self._live_bytes += nbytes
        self._cost.peak_bytes = max(self._cost.peak_bytes, self._live_bytes)

    def _hold(self, keys: set, n: int) -> None:
        """Each of ``keys`` still live counts ``n`` times until freed."""
        for key in keys:
            if key in self._live:
                extra = self._live[key] * (n - 1)
                self._live[key] += extra
                self._grow(extra)

    def _free(self, key: int) -> None:
        if not self._closed and key in self._live:
            self._live_bytes -= self._live.pop(key)
            for trip in self._unheld:  # a new storage may take the freed one's key
                trip._keys.discard(key)

    def _leaves(self, trees) -> list[torch.Tensor]:
        out = []
        for x in _tensors(trees):
            if self._dtensor is not None and isinstance(x, self._dtensor):
                x = x._local_tensor
            out.append(x)
        return out

    @contextlib.contextmanager
    def paused(self):
        """Count nothing within (a wrapper's own bookkeeping)."""
        was, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = was

    def arguments(self, *trees) -> None:
        """The step's inputs (each DTensor's local shard): live from the
        start, counted in ``argument_bytes``."""
        with self.paused():
            for t in self._leaves(trees):
                key = self._track(t)
                if key is not None and key not in self._args:
                    self._args.add(key)
                    self._cost.argument_bytes += self._live[key]

    def outputs(self, *trees) -> None:
        """The step's results: their storages that are not arguments count
        in ``output_bytes``."""
        with self.paused():
            seen = set()
            for t in self._leaves(trees):
                key = self._track(t)
                if key is not None and key not in self._args and key not in seen:
                    seen.add(key)
                    self._cost.output_bytes += self._live[key]

    def close(self) -> Cost:
        """Stop following storages; the totals."""
        self._closed = True
        return self._cost


def count(fn: Callable, *args: Any, meshes: Iterable = (), **kwargs: Any) -> tuple[Any, Cost]:
    """``fn(*args, **kwargs)`` under a new counter, with ``args`` as its
    arguments and the result as its outputs: ``(result, cost)``."""
    counter = OpCounter(meshes=meshes)
    with counter:
        counter.arguments(args, kwargs)
        out = fn(*args, **kwargs)
        counter.outputs(out)
    return out, counter.close()

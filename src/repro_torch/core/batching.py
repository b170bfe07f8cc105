"""The public autobatching entry point (the ``vmap``-like surface).

:func:`autobatch` is a decorator over restricted Python (or a call over a
builder-built program) returning a callable over **positional pytree
arguments**::

    from repro_torch.core.batching import autobatch, Batched, Shared
    from repro_torch.core.frontend import I32

    @autobatch(in_specs=(Batched(I32),), out_spec=I32, max_depth=24)
    def fib(n):
        if n < 2:
            return n
        return fib(n - 1) + fib(n - 2)

    fib(torch.arange(8, dtype=torch.int32))     # -> [8] int32 tensor

It also takes a :class:`frontend.ProgramBuilder`, a
:class:`frontend.FunctionBuilder`, an :class:`ir.Function` or an
:class:`ir.Program`, and with no target it returns a decorator with the
options fixed.  The restricted-Python source goes through
:mod:`.ast_frontend`; every function registered in one
:class:`ast_frontend.Namespace` may call the others, whichever frontend
defined them.

``Batched(spec)`` arguments carry a leading batch axis on every leaf, whose
length is the batch size (or ``batch_size=``, fixed and validated);
``Shared(spec)`` arguments have none and are broadcast to every member.
Specs are pytrees of :class:`ir.Spec` (tensors, arrays and dtypes are
accepted); an argument's leaves bind to consecutive IR parameters in JAX's
flatten order (:mod:`.tree`), recorded on the main function as an
:class:`ir.Interface`.  The result is the ``out_spec`` pytree: a single
spec gives a bare tensor, name-string leaves pick outputs, and the default
is a dict keyed by output name.

Backends, as in the JAX package:

* ``"pc"`` (default): the program goes through ``lowering.lower`` ->
  ``passes.fusion_passes()`` (unless ``fuse=False``) ->
  ``DeadCodeElimination``, lowered once per function, and runs on the
  program-counter VM (:mod:`.pc_vm`) with its ``schedule``,
  ``compact_every`` and ``collect_stats`` knobs.  The stacks default to
  the statically inferred depth bound (a recursive program falls back to
  :data:`DEFAULT_MAX_DEPTH`).  Faults follow ``on_fault``: under
  ``"raise"`` (the default) a run in which any member overflows raises
  :class:`pc_vm.StackOverflow`, and one with a non-finite write
  (``detect_nonfinite``) or a lane over its ``lane_step_budget`` raises
  :class:`pc_vm.LaneFault`; under ``"quarantine"`` nothing raises and the
  faulted lanes are flagged in ``last_result.fault_code``.
  :meth:`AutobatchedFunction.stepper` runs it in segments (:class:`Stepper`).
  ``verify=True`` runs the lowered-IR verifier (:mod:`.verifier`) between
  every pass; ``trace=`` records every dispatch into the VM's ring
  (``fn.last_trace``, ``Stepper.trace``); ``pgo=`` (a
  :class:`repro_torch.obs.BlockProfile` or a path to one) re-lowers
  through ``passes.pgo_passes``, which :meth:`AutobatchedFunction.optimize`
  does for a profile of a traced run;
* ``"local"`` / ``"local_eager"``: local static autobatching
  (:mod:`.local_static`, paper Algorithm 1) with each block segment
  replayed from a CUDA graph, or op by op;
* ``"reference"``: the unbatched interpreter, one member at a time.

The frontend traces once per function and the pc lowering happens once,
shared by every batch size; executors are cached under ``(backend, device,
batch size, input avals, schedule, fuse, verify, compact_every, trace
capacity, profile digest, mesh, fault options)``, and :meth:`AutobatchedFunction.
cache_info` counts hits, misses, entries, lowerings and traces.
:meth:`AutobatchedFunction.with_options` makes a clone with other knobs
that shares the traced program, and the lowering while ``fuse``,
``verify``, the device and the profile are the same.  ``tag_stats`` and
``utilization`` cover the most recent call on every backend (``{}`` for
``reference``, which keeps no counters); ``scheduler_stats`` is the pc
VM's :class:`pc_vm.SchedulerStats`.

Everything runs on ``device``: the CUDA card unless the caller passes
another device (``device="cpu"`` for the tests).  With no device given the
card is resolved at the first call or lowering, so a module-level
``@autobatch`` imports on a machine with no card, where the first call
raises.  The JAX package's ``lower()`` (an
XLA ahead-of-time handle) is not ported.

``mesh=`` (pc backend) shards the lanes over the ranks of a
``torch.distributed`` process group (``pc_vm.VMConfig.mesh``): every rank
calls the function with the whole batch, runs its share of the lanes on
its own device (by default ``cuda:{local_rank % device_count}``) and gets
lane-sharded ``DTensor`` outputs; ``repro_torch.distributed.host_lanes``
gathers one to the host.
"""
from __future__ import annotations

import functools
import inspect
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .. import distributed
from ..device import resolve_device
from ..obs import blockprof, trace as obs_trace
from . import (analysis, ast_frontend, frontend, ir, local_static, lowering, passes, pc_vm,
               reference, tree)

__all__ = ["Batched", "Shared", "AutobatchedFunction", "CacheInfo", "Stepper", "autobatch",
           "DEFAULT_NAMESPACE"]

BACKENDS = ("pc", "local", "local_eager", "reference")

#: Stack depth when ``max_depth=None`` and the program is recursive: an
#: input-dependent call depth has no static bound.
DEFAULT_MAX_DEPTH = 32

#: The default frontend namespace: ``@autobatch`` registrations land here
#: unless ``registry=`` names another, so decorated functions in one module
#: can call decorated (or builder-registered) functions in another.
DEFAULT_NAMESPACE = ast_frontend.Namespace()


class Batched:
    """Per-member argument: every call-time leaf carries a leading batch axis."""

    shared = False

    def __init__(self, spec: Any):
        self.spec = spec

    def __repr__(self) -> str:
        return f"Batched({self.spec!r})"


class Shared:
    """Broadcast argument: one value shared by every batch member."""

    shared = True

    def __init__(self, spec: Any):
        self.spec = spec

    def __repr__(self) -> str:
        return f"Shared({self.spec!r})"


def _as_dtype(d: Any) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    return torch.from_numpy(np.empty(0, np.dtype(d))).dtype


def _as_spec(x: Any) -> ir.Spec:
    """A spec leaf as an :class:`ir.Spec`: a spec, anything with a shape and
    a dtype (a tensor, an array), or a dtype (a scalar)."""
    if isinstance(x, ir.Spec):
        return x
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return ir.Spec(tuple(x.shape), _as_dtype(x.dtype))
    return ir.Spec((), _as_dtype(x))


def _flatten_spec(entry: Any) -> tuple[list[ir.Spec], tree.TreeDef, bool]:
    """One ``in_specs`` entry -> (leaf specs, treedef, shared)."""
    wrap = entry if isinstance(entry, (Batched, Shared)) else Batched(entry)
    leaves, treedef = tree.tree_flatten(wrap.spec)
    if not leaves:
        raise TypeError(f"argument spec {entry!r} has no leaves")
    return [_as_spec(leaf) for leaf in leaves], treedef, wrap.shared


def _raise_if_overflowed(flags: np.ndarray, batch_size: int, max_depth: int,
                         hint: str) -> None:
    """Silently corrupted members (dropped pushes) must never escape."""
    if flags.any():
        lanes = np.flatnonzero(flags)
        shown = ", ".join(str(i) for i in lanes[:8])
        if len(lanes) > 8:
            shown += ", ..."
        raise pc_vm.StackOverflow(
            f"pc/variable stack overflow: {len(lanes)} of "
            f"{batch_size} batch members exceeded max_depth={max_depth} "
            f"(lanes {shown}); their results would be invalid "
            "(out-of-range pushes are dropped). " + hint,
            depth_exceeded=flags,
            lanes=lanes,
        )


def _raise_if_faulted(codes: np.ndarray, batch_size: int) -> None:
    """The gate for non-finite and watchdog faults under ``on_fault="raise"``:
    the batch is aborted with the per-lane codes on the exception."""
    bad = codes >= pc_vm.FAULT_NONFINITE
    if bad.any():
        lanes = np.flatnonzero(bad)
        kinds = sorted({pc_vm.FAULT_NAMES[int(codes[i])] for i in lanes})
        shown = ", ".join(str(i) for i in lanes[:8])
        if len(lanes) > 8:
            shown += ", ..."
        raise pc_vm.LaneFault(
            f"lane fault ({'/'.join(kinds)}): {len(lanes)} of {batch_size} "
            f"batch members faulted (lanes {shown}); their results would "
            "be invalid. Pass on_fault='quarantine' to autobatch() to "
            "contain faults per lane instead of aborting the batch.",
            fault_codes=codes,
        )


def _as_profile(pgo: Any) -> Optional[blockprof.BlockProfile]:
    """The ``pgo=`` knob: None, a ``BlockProfile``, or a path to a profile
    JSON saved by ``BlockProfile.save`` (by either package; loaded here)."""
    if pgo is None:
        return None
    if isinstance(pgo, (str, os.PathLike)):
        return blockprof.BlockProfile.load(pgo)
    if hasattr(pgo, "dispatches") and hasattr(pgo, "digest"):
        return pgo
    raise TypeError(
        "pgo= expects a repro_torch.obs.BlockProfile (or a path to one "
        f"saved as JSON), got {type(pgo).__name__}"
    )


class _PcExecutor:
    def __init__(self, lowered: ir.LoweredProgram, main: str,
                 config: pc_vm.VMConfig, device, overflow_hint: str):
        self.main = main
        self.batch_size = config.batch_size
        self.overflow_hint = overflow_hint
        self.vm = pc_vm.ProgramCounterVM(lowered, config, device)
        self.last_result: Optional[pc_vm.VMResult] = None

    def qualify(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {ir.qualify(self.main, k): v for k, v in inputs.items()}

    def check(self, depth_exceeded: torch.Tensor, fault_code: torch.Tensor) -> None:
        """Under ``on_fault="raise"``, raise on the faults of a finished run
        (caller lane order, the whole batch under a mesh, so every rank
        raises alike): overflow, then the enabled detectors."""
        cfg = self.vm.config
        if cfg.on_fault != "raise":
            return
        _raise_if_overflowed(distributed.host_lanes(depth_exceeded).numpy(), self.batch_size,
                             cfg.max_depth, self.overflow_hint)
        if cfg.detect_nonfinite or cfg.lane_step_budget is not None:
            _raise_if_faulted(distributed.host_lanes(fault_code).numpy(), self.batch_size)

    def run(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        res = self.vm.run(self.qualify(inputs))
        self.last_result = res
        self.check(res.depth_exceeded, res.fault_code)
        return {k.split("/", 1)[1]: v for k, v in res.outputs.items()}

    @property
    def tag_stats(self) -> dict[str, tuple[int, int]]:
        return dict(self.last_result.tag_stats) if self.last_result else {}


class _LocalExecutor:
    def __init__(self, program: ir.Program, batch_size: int, jit_blocks: bool, device):
        self.batch_size = batch_size
        self.batcher = local_static.LocalStaticBatcher(
            program, batch_size, jit_blocks=jit_blocks, device=device
        )
        self._ran = False
        self.last_result = None

    def run(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        # Counters of this run only, as the pc executor's.
        self.batcher.stats = local_static.LocalStats()
        out = self.batcher.run(inputs)
        self._ran = True
        return out

    @property
    def tag_stats(self) -> dict[str, tuple[int, int]]:
        if not self._ran:
            return {}
        st = self.batcher.stats
        return {tag: (st.tag_execs[tag], st.tag_active.get(tag, 0)) for tag in st.tag_execs}


class _ReferenceExecutor:
    def __init__(self, program: ir.Program, batch_size: int):
        self.program = program
        self.batch_size = batch_size
        self.last_result = None
        self.tag_stats: dict[str, tuple[int, int]] = {}

    def run(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return reference.run_reference_batch(self.program, inputs)


class Stepper:
    """Segmented, resumable execution of an autobatched function (pc
    backend only); made by :meth:`AutobatchedFunction.stepper`.

    The caller holds the VM state and advances it in segments, so a host
    loop can retire finished lanes and refill them between segments::

        st = fn.stepper(*args)
        state = st.init()
        while not st.done(state):
            state = st.step(state, 64)  # <= 64 loop iterations
        out = st.result(state)          # == fn(*args), bit for bit

    ``step``, ``inject`` and ``park`` update the state in place and return
    it (the JAX package's donate the snapshot); a chain of segments of any
    sizes is bit-exact with the single call.  Per-lane views are in the
    caller's lane order whatever ``compact_every`` does.
    """

    def __init__(self, fn: "AutobatchedFunction", inputs: dict, z: int):
        self._fn = fn
        self._ex = fn._executor(fn._key(inputs, z), z)
        self._inputs = inputs
        self.batch_size = z

    @property
    def vm(self) -> pc_vm.ProgramCounterVM:
        """The VM (shared with plain calls at this batch size)."""
        return self._ex.vm

    def _bind(self, args: tuple, what: str) -> dict:
        inputs, z = self._fn._bind(args)
        if z != self.batch_size:
            raise TypeError(f"stepper.{what}: batch size {z} != {self.batch_size}")
        return self._ex.qualify(inputs)

    def init(self, *args) -> dict:
        """A fresh initial state: of the values ``stepper(...)`` was made
        with, or of new ones (same pytrees and shapes)."""
        inputs = self._bind(args, "init") if args else self._ex.qualify(self._inputs)
        return self.vm.init_state(inputs)

    def step(self, state: dict, num_steps: int) -> dict:
        """Advance by at most ``num_steps`` VM loop iterations."""
        return self.vm.run_segment(state, num_steps)

    def lane_done(self, state: dict) -> torch.Tensor:
        """``[batch]`` bool: which lanes have halted."""
        return self.vm.lane_done(state)

    def fault_code(self, state: dict) -> torch.Tensor:
        """``[batch]`` int32 fault codes (``pc_vm.FAULT_NAMES``)."""
        return self.vm.lane_fault(state)

    def lane_faulted(self, state: dict) -> torch.Tensor:
        """``[batch]`` bool: which lanes have faulted; under
        ``on_fault="quarantine"`` they never advance again until
        ``inject`` resets them."""
        return self.vm.lane_faulted(state)

    def lane_status(self, state: dict) -> tuple[np.ndarray, np.ndarray]:
        """The halt flags (bool) and fault codes (int32) of the whole batch
        as host arrays, read in one transfer (under a mesh, one all-gather:
        every rank gets every lane's)."""
        status = distributed.host_lanes(self.vm.lane_status(state)).numpy()
        return status[0].astype(bool), status[1]

    def done(self, state: dict) -> bool:
        """True once the VM cannot advance this state: every lane halted or
        faulted, a fatal fault stopped the loop (``"raise"`` with a
        detector on), or ``max_steps`` is spent — exactly when a single
        call would return."""
        done, codes = self.lane_status(state)
        if (done | (codes != pc_vm.FAULT_OK)).all():
            return True
        if self.vm._fail_fast() and (codes >= pc_vm.FAULT_NONFINITE).any():
            return True
        return self.steps(state) >= self.vm.config.max_steps

    def steps(self, state: dict) -> int:
        """VM loop iterations run on this state, over all segments."""
        return int(state["steps"])

    def trace(self, state: dict):
        """The :class:`repro_torch.obs.trace.DispatchTrace` of every
        dispatch on this state so far, over all segments (one host read;
        the ring is not consumed), or None without ``trace=``."""
        return self.vm.get_trace(state)

    def park(self, state: dict, mask) -> dict:
        """Park the masked lanes at the exit block (idle until injected)."""
        return self.vm.park(state, mask)

    def inject(self, state: dict, mask, *args) -> dict:
        """Re-initialize the masked lanes with fresh arguments, given with
        the function's calling convention (positional pytrees) at full batch
        width (only the masked rows are read).  Other lanes are untouched."""
        return self.vm.inject(state, mask, self._bind(args, "inject"))

    def depth_exceeded(self, state: dict) -> torch.Tensor:
        """``[batch]`` bool: lanes whose stacks overflowed ``max_depth``."""
        return self.vm.lane_depth_exceeded(state)

    def outputs(self, state: dict) -> Any:
        """The output pytree of a state, without the fault checks: final
        rows for halted lanes, whatever in-flight lanes wrote so far."""
        iface, main = self._fn._iface, self._ex.main
        # read_top slices a packed output (pgo=) out of its group.
        return tree.tree_unflatten(iface.out_treedef, [
            self.vm.lanes_of(state, self.vm.read_top(state, ir.qualify(main, name)))
            for name in iface.out_leaves])

    def result(self, state: dict) -> Any:
        """The outputs with a plain call's fault checks: under
        ``on_fault="raise"`` raise :class:`pc_vm.StackOverflow` or
        :class:`pc_vm.LaneFault`; under ``"quarantine"`` never raise."""
        self._ex.check(self.vm.lane_depth_exceeded(state), self.vm.lane_fault(state))
        return self.outputs(state)


@dataclass(frozen=True)
class CacheInfo:
    """:meth:`AutobatchedFunction.cache_info`: calls that found (``hits``)
    or made (``misses``) an executor, executors made (``entries``), pc
    lowerings and frontend traces."""

    hits: int
    misses: int
    entries: int
    lowerings: int
    traces: int


class AutobatchedFunction:
    """A batched callable over positional pytree arguments; made by
    :func:`autobatch`.

    A call flattens each argument against its ``Batched``/``Shared`` spec,
    broadcasts shared leaves across the batch, runs the backend and
    unflattens the IR outputs into the declared result pytree.
    """

    def __init__(
        self,
        *,
        registry: ast_frontend.Namespace,
        main: str,
        program: Optional[ir.Program],
        iface_args: tuple[ir.ArgBinding, ...],
        arg_specs: dict[str, ir.Spec],
        out_treedef: tree.TreeDef,
        out_leaves: tuple[str, ...],
        backend: str,
        batch_size: Optional[int],
        max_depth: Optional[int],
        max_steps: int,
        collect_stats: bool,
        schedule: str,
        fuse: bool,
        compact_every: Optional[int],
        on_fault: str,
        detect_nonfinite: bool,
        lane_step_budget: Optional[int],
        verify: bool = False,
        trace: Any = None,
        pgo: Any = None,
        mesh: Any = None,
        device: Any = None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if mesh is not None and backend != "pc":
            raise ValueError(f"mesh= shards the pc backend's lanes; backend={backend!r} "
                             "runs on one device")
        if schedule not in pc_vm.SCHEDULES:
            raise ValueError(
                f"schedule must be one of {pc_vm.SCHEDULES}, got {schedule!r}"
            )
        self.registry = registry
        self.main = main
        self.backend = backend
        self.batch_size = batch_size
        self.max_depth = max_depth  # None: use the static bound
        self.max_steps = max_steps
        self.collect_stats = collect_stats
        self.schedule = schedule
        self.fuse = fuse
        self.compact_every = compact_every
        self.on_fault = on_fault
        self.detect_nonfinite = detect_nonfinite
        self.lane_step_budget = lane_step_budget
        self.verify = verify
        self.trace = trace
        self.pgo = _as_profile(pgo)
        self.mesh = mesh  # resolved with the executor (it needs the ranks)
        self._device_arg = device  # resolved at the first call or lowering
        self._device: Optional[torch.device] = None
        self._program = program
        self._iface = ir.Interface(args=iface_args, out_treedef=out_treedef,
                                   out_leaves=out_leaves)
        self._arg_specs = arg_specs
        # Constructor arguments, for with_options() clones.
        self._init_kwargs = dict(
            registry=registry, main=main, program=program, iface_args=iface_args,
            arg_specs=arg_specs, out_treedef=out_treedef, out_leaves=out_leaves,
            backend=backend, batch_size=batch_size, max_depth=max_depth,
            max_steps=max_steps, collect_stats=collect_stats, schedule=schedule,
            fuse=fuse, compact_every=compact_every, on_fault=on_fault,
            detect_nonfinite=detect_nonfinite, lane_step_budget=lane_step_budget,
            verify=verify, trace=trace, pgo=self.pgo, mesh=mesh, device=device,
        )
        self._lowered: Optional[ir.LoweredProgram] = None
        self._depth_report: Optional[analysis.StackDepthReport] = None
        # Executors by cache key; the keys calls have seen (cache_info).
        self._executors: dict[tuple, Any] = {}
        self._called: set[tuple] = set()
        self._hits = self._misses = self._lower_count = self._trace_count = 0
        self._last_executor: Any = None
        # What this wrapper re-asserts into the namespace before its (lazy)
        # first trace, so that it traces its own definition even if another
        # registration shadowed the name since: the decorator pins
        # (fn, param_specs, output_specs), the builder paths the
        # ir.Function objects they registered.
        self._pinned: Optional[tuple] = None
        self._pinned_funcs: dict[str, ir.Function] = {}
        self.__name__ = main

    @property
    def device(self) -> torch.device:
        """Where everything runs: resolved at first use (the CUDA card
        unless ``device=`` named another; under a mesh, this rank's card;
        no CUDA and no device raises)."""
        if self._device is None:
            self._device = (resolve_device(self._device_arg) if self.mesh is None
                            else distributed.rank_device(self._device_arg))
        return self._device

    @property
    def program(self) -> ir.Program:
        """The Fig-2 IR program (traced once, then cached), its main
        function carrying this wrapper's :class:`ir.Interface`."""
        if self._program is None:
            if self._pinned is not None:
                fn, param_specs, output_specs = self._pinned
                if self.registry._pyfns.get(self.main) is not fn:
                    self.registry.define(param_specs, output_specs)(fn)
            for fname, func in self._pinned_funcs.items():
                if self.registry._built.get(fname) is not func:
                    self.registry.add(func)
            self._program = self.registry.trace(self.main)
            self._trace_count += 1
        main_fn = self._program.functions[self._program.main]
        if main_fn.iface is not self._iface:
            # Record this wrapper's calling convention without mutating a
            # Function that other wrappers (or the caller) may share.
            self._program = ir.Program(
                functions={**self._program.functions,
                           self._program.main: ir.dataclass_replace(main_fn,
                                                                    iface=self._iface)},
                main=self._program.main,
            )
        return self._program

    @property
    def lowered(self) -> ir.LoweredProgram:
        """The stack-explicit program of the pc backend (lowered once, for
        every batch size): fused (unless ``fuse=False``) and
        dead-code-eliminated, then, with ``pgo=``, put through the
        profile-guided passes (``passes.pgo_passes``), whose profile must
        come from this ``fuse`` setting.  ``verify=True`` runs the verifier
        on every pass's output."""
        if self._lowered is None:
            low = lowering.lower(self.program, self.device, verify=self.verify)
            post = [*(passes.fusion_passes() if self.fuse else []),
                    passes.DeadCodeElimination()]
            if self.pgo is not None:
                post.extend(passes.pgo_passes(self.pgo))
            self._lowered = passes.PassPipeline(
                post, verify=self.verify, debug=self.verify).run(low)
            self._lower_count += 1
        return self._lowered

    def _pgo_digest(self) -> Optional[str]:
        return None if self.pgo is None else self.pgo.digest()

    def with_options(self, **overrides: Any) -> "AutobatchedFunction":
        """A clone with some knobs changed (the :func:`autobatch` keyword
        names, e.g. ``trace=4096``, ``schedule="lookahead"`` or
        ``device="cpu"``).  It shares the traced program and, while
        ``fuse``, ``verify``, the device and the profile digest are
        unchanged, the lowering."""
        unknown = set(overrides) - set(self._init_kwargs)
        if unknown:
            raise TypeError(
                f"with_options: unknown option(s) {sorted(unknown)}; "
                f"valid names: {sorted(self._init_kwargs)}"
            )
        kw = {**self._init_kwargs, **overrides}
        clone = AutobatchedFunction(**kw)
        clone._pinned = self._pinned
        clone._pinned_funcs = dict(self._pinned_funcs)
        clone._program = self._program
        if (all(kw[k] == self._init_kwargs[k] for k in ("fuse", "verify", "device"))
                and clone._pgo_digest() == self._pgo_digest()):
            clone._lowered = self._lowered
            clone._depth_report = self._depth_report
        return clone

    def optimize(self, profile: Any) -> "AutobatchedFunction":
        """A clone re-lowered through the profile-guided passes:
        ``with_options(pgo=profile)``, where ``profile`` is a
        :class:`repro_torch.obs.BlockProfile` of a traced run of this
        function (``obs.block_profile(fn.last_trace)``) or a path to a
        saved one.  Bit-exact, with its own executors."""
        return self.with_options(pgo=profile)

    def cache_info(self) -> CacheInfo:
        """The executor cache's counters: ``hits``/``misses`` count calls
        against the cache key, ``entries`` the keys calls have made,
        ``lowerings`` the pc lowerings (at most one, whatever the batch
        sizes) and ``traces`` the frontend traces."""
        return CacheInfo(hits=self._hits, misses=self._misses, entries=len(self._called),
                         lowerings=self._lower_count, traces=self._trace_count)

    def diagnostics(self) -> passes.Diagnostics:
        """The verifier and static-analysis report over the lowered program
        (:func:`passes.diagnose`; pc backend only, the others never lower).
        ``tools/torch_irlint.py`` prints the same report."""
        if self.backend != "pc":
            raise ValueError("diagnostics() requires the 'pc' backend")
        return passes.diagnose(self.lowered)

    def lower(self, *args):
        """Not ported: the JAX package's ahead-of-time XLA handle."""
        raise NotImplementedError(
            "lower() (an ahead-of-time compiled handle) is not ported yet "
            "(ROADMAP item 4)")

    @property
    def depth_report(self) -> analysis.StackDepthReport:
        if self._depth_report is None:
            self._depth_report = analysis.stack_depth_bound(self.lowered)
        return self._depth_report

    @property
    def resolved_max_depth(self) -> int:
        """An explicit ``max_depth`` wins; else the static bound, or
        :data:`DEFAULT_MAX_DEPTH` for a recursive program."""
        if self.max_depth is not None:
            return self.max_depth
        bound = self.depth_report.required_max_depth
        return DEFAULT_MAX_DEPTH if bound is None else bound

    def _overflow_hint(self) -> str:
        rep = self.depth_report
        if rep.recursive_cycle is not None:
            cyc = " -> ".join(rep.recursive_cycle + rep.recursive_cycle[:1])
            return (
                f"The program is recursive ({cyc}), so the required depth "
                "depends on the inputs; pass a larger max_depth= to "
                "autobatch()."
            )
        return (
            "The statically inferred bound for this program is "
            f"max_depth={rep.required_max_depth}; pass max_depth= at least "
            "that (or max_depth=None to use the bound) to autobatch()."
        )

    def _bind(self, args: tuple) -> tuple[dict[str, torch.Tensor], int]:
        iface = self._iface
        if len(args) != len(iface.args):
            raise TypeError(
                f"{self.main}() takes {len(iface.args)} positional "
                f"argument(s), got {len(args)}"
            )
        flat: list[tuple[ir.ArgBinding, list]] = []
        for i, (binding, arg) in enumerate(zip(iface.args, args)):
            leaves, treedef = tree.tree_flatten(arg)
            if treedef != binding.treedef:
                raise TypeError(
                    f"{self.main}() argument {i}: pytree structure "
                    f"{treedef} does not match declared {binding.treedef}"
                )
            flat.append((binding, leaves))
        # The batch size: fixed, or the first batched leaf's leading axis.
        z = self.batch_size
        for binding, leaves in flat:
            if binding.shared:
                continue
            for name, leaf in zip(binding.params, leaves):
                spec = self._arg_specs[name]
                shape = tuple(np.shape(leaf))
                if len(shape) != len(spec.shape) + 1:
                    raise TypeError(
                        f"{self.main}() batched leaf {name!r}: expected a "
                        f"leading batch axis over {spec.shape}, got shape {shape}"
                    )
                if z is None:
                    z = int(shape[0])
                elif shape[0] != z:
                    raise TypeError(
                        f"{self.main}() batched leaf {name!r}: batch axis "
                        f"{shape[0]} != {z}"
                    )
        if z is None:
            raise TypeError(
                f"{self.main}() has no Batched arguments; pass batch_size= to autobatch()"
            )
        inputs: dict[str, torch.Tensor] = {}
        for binding, leaves in flat:
            for name, leaf in zip(binding.params, leaves):
                spec = self._arg_specs[name]
                x = torch.as_tensor(leaf).to(device=self.device, dtype=spec.dtype)
                if binding.shared:
                    if tuple(x.shape) != spec.shape:
                        raise TypeError(
                            f"{self.main}() shared argument leaf {name!r}: expected "
                            f"shape {spec.shape}, got {tuple(x.shape)}"
                        )
                    x = x.expand((z,) + spec.shape)
                elif tuple(x.shape) != (z,) + spec.shape:
                    raise TypeError(
                        f"{self.main}() batched leaf {name!r}: expected "
                        f"shape {(z,) + spec.shape}, got {tuple(x.shape)}"
                    )
                inputs[name] = x
        return inputs, z

    def _key(self, inputs: dict[str, torch.Tensor], z: int) -> tuple:
        """The executor cache key.  ``_bind`` fixes every leaf's shape and
        dtype by the batch size, so the avals follow ``z``; they stay in
        the key, and so do the knobs fixed per wrapper, so that two
        wrappers with other knobs never share an executor."""
        return (
            self.backend,
            self.device,
            z,
            tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items())),
            self.schedule,
            self.fuse,
            self.verify,
            self.compact_every,
            obs_trace.resolve_capacity(self.trace),
            self._pgo_digest(),
            pc_vm.mesh_cache_key(self.mesh),
            self.on_fault,
            self.detect_nonfinite,
            self.lane_step_budget,
        )

    def _executor(self, key: tuple, z: int):
        ex = self._executors.get(key)
        if ex is not None:
            return ex
        if self.backend == "pc":
            ex = _PcExecutor(
                self.lowered, self.main,
                pc_vm.VMConfig(
                    batch_size=z, max_depth=self.resolved_max_depth,
                    max_steps=self.max_steps,
                    collect_block_stats=self.collect_stats,
                    schedule=self.schedule, compact_every=self.compact_every,
                    on_fault=self.on_fault, detect_nonfinite=self.detect_nonfinite,
                    lane_step_budget=self.lane_step_budget, trace=self.trace,
                    mesh=self.mesh,
                ),
                self.device, self._overflow_hint(),
            )
        elif self.backend in ("local", "local_eager"):
            ex = _LocalExecutor(self.program, z, self.backend == "local", self.device)
        else:
            ex = _ReferenceExecutor(self.program, z)
        self._executors[key] = ex
        return ex

    def __call__(self, *args) -> Any:
        inputs, z = self._bind(args)
        key = self._key(inputs, z)
        if key in self._called:
            self._hits += 1
        else:
            self._misses += 1
            self._called.add(key)
        ex = self._executor(key, z)
        self._last_executor = ex
        out = ex.run(inputs)
        return tree.tree_unflatten(self._iface.out_treedef,
                                   [out[name] for name in self._iface.out_leaves])

    def stepper(self, *args) -> Stepper:
        """A :class:`Stepper` over these arguments (pc backend only); it
        shares the executor of plain calls at this batch size."""
        if self.backend != "pc":
            raise ValueError("stepper requires the 'pc' backend")
        inputs, z = self._bind(args)
        return Stepper(self, inputs, z)

    @property
    def last_result(self) -> Optional[pc_vm.VMResult]:
        """The :class:`pc_vm.VMResult` of the most recent pc-backend call."""
        return self._last_executor.last_result if self._last_executor else None

    @property
    def last_trace(self):
        """The :class:`repro_torch.obs.trace.DispatchTrace` of the most
        recent pc-backend call; None before one or without ``trace=``."""
        res = self.last_result
        return res.trace if res is not None else None

    @property
    def scheduler_stats(self) -> Optional[pc_vm.SchedulerStats]:
        """The VM's scheduling summary of the most recent pc-backend call
        (schedule, steps, occupancies, masked updates); None before one."""
        res = self.last_result
        return res.sched if res is not None else None

    @property
    def local_stats(self) -> Optional[local_static.LocalStats]:
        """The counters (blocks, primitives, tags) of the most recent
        ``local``/``local_eager`` call; None before one."""
        ex = self._last_executor
        return ex.batcher.stats if isinstance(ex, _LocalExecutor) and ex._ran else None

    @property
    def tag_stats(self) -> dict[str, tuple[int, int]]:
        """tag -> (primitive executions, active member-executions) of the
        most recent call on every backend; ``{}`` before any call (and
        always for ``reference``)."""
        return self._last_executor.tag_stats if self._last_executor else {}

    @property
    def utilization(self) -> dict[str, float]:
        """Per-tag batch utilization of the last run (paper Fig. 6):
        ``active / (executions * batch_size)``."""
        ex = self._last_executor
        if ex is None:
            return {}
        z = ex.batch_size
        return {
            tag: (act / (execs * z) if execs else 0.0)
            for tag, (execs, act) in self.tag_stats.items()
        }


# --------------------------------------------------------------------------
# Interface construction
# --------------------------------------------------------------------------


def _bind_in_specs(
    name: str,
    params: tuple[str, ...],
    in_specs: Sequence,
    declared: Optional[dict[str, ir.Spec]] = None,
) -> tuple[tuple[ir.ArgBinding, ...], dict[str, ir.Spec]]:
    """Map ``in_specs`` entries onto IR parameters in flatten order."""
    bindings: list[ir.ArgBinding] = []
    arg_specs: dict[str, ir.Spec] = {}
    idx = 0
    for entry in in_specs:
        leaf_specs, treedef, shared = _flatten_spec(entry)
        names = params[idx: idx + len(leaf_specs)]
        if len(names) != len(leaf_specs):
            raise TypeError(
                f"{name}: in_specs bind {idx + len(leaf_specs)} leaves but "
                f"the function has only {len(params)} parameters"
            )
        for p, spec in zip(names, leaf_specs):
            if declared is not None and spec != declared[p]:
                raise TypeError(
                    f"{name}: in_specs leaf for parameter {p!r} is {spec} "
                    f"but the program declares {declared[p]}"
                )
            arg_specs[p] = spec
        bindings.append(ir.ArgBinding(tuple(names), treedef, shared))
        idx += len(leaf_specs)
    if idx != len(params):
        raise TypeError(
            f"{name}: in_specs cover {idx} of {len(params)} parameters "
            f"({params[idx:]} unbound)"
        )
    return tuple(bindings), arg_specs


def _contains_dict(x: Any) -> bool:
    if isinstance(x, dict):
        return True
    if isinstance(x, (list, tuple)):
        return any(_contains_dict(c) for c in x)
    return False


def _bind_out_spec(
    name: str,
    outputs: tuple[str, ...],
    out_spec: Any,
    declared: Optional[dict[str, ir.Spec]] = None,
) -> tuple[tree.TreeDef, tuple[str, ...]]:
    """The result pytree -> (treedef, IR output name of each leaf)."""
    if out_spec is None:
        # Default: a dict keyed by the IR output names.
        leaves, treedef = tree.tree_flatten({o: o for o in outputs})
        return treedef, tuple(leaves)
    leaves, treedef = tree.tree_flatten(out_spec)
    if all(isinstance(leaf, str) for leaf in leaves):
        # Name-based restructuring: leaves name IR outputs.
        for leaf in leaves:
            if leaf not in outputs:
                raise TypeError(
                    f"{name}: out_spec names unknown output {leaf!r} "
                    f"(have {outputs})"
                )
        return treedef, tuple(leaves)
    # Spec leaves bind positionally to the declared outputs in flatten
    # order; a dict flattens in sorted-key order, which would silently
    # permute equal-spec outputs, so it must use name-string leaves.
    if _contains_dict(out_spec):
        raise TypeError(
            f"{name}: out_spec dicts with spec leaves are ambiguous "
            "(dict flatten order is sorted-key, not declaration order); "
            "use output-name strings as leaves, e.g. "
            "out_spec={'mean': 'sum_theta'}"
        )
    if len(leaves) != len(outputs):
        raise TypeError(
            f"{name}: out_spec has {len(leaves)} leaves for {len(outputs)} outputs"
        )
    if declared is not None:
        for o, leaf in zip(outputs, leaves):
            spec = _as_spec(leaf)
            if spec != declared[o]:
                raise TypeError(
                    f"{name}: out_spec leaf for output {o!r} is {spec} "
                    f"but the program declares {declared[o]}"
                )
    return treedef, tuple(outputs)


# --------------------------------------------------------------------------
# The decorator / entry point
# --------------------------------------------------------------------------


def autobatch(
    target: Any = None,
    *,
    in_specs: Optional[Sequence] = None,
    out_spec: Any = None,
    backend: str = "pc",
    batch_size: Optional[int] = None,
    max_depth: Optional[int] = None,
    max_steps: int = 1_000_000,
    collect_stats: bool = True,
    schedule: str = "earliest",
    fuse: bool = True,
    compact_every: Optional[int] = None,
    on_fault: str = "raise",
    detect_nonfinite: bool = False,
    lane_step_budget: Optional[int] = None,
    verify: bool = False,
    trace: Any = None,
    pgo: Any = None,
    mesh: Any = None,
    registry: Optional[ast_frontend.Namespace] = None,
    device=None,
):
    """Autobatch a restricted-Python function or an IR program.

    Three ways to call it:

    1. as a decorator over restricted Python (``in_specs`` and ``out_spec``
       required; each parameter a single-leaf spec)::

           @autobatch(in_specs=(Batched(I32),), out_spec=I32)
           def fib(n): ...

    2. over a :class:`frontend.ProgramBuilder`, a
       :class:`frontend.FunctionBuilder` / :class:`ir.Function`, or an
       :class:`ir.Program`: ``in_specs`` defaults to ``Batched`` of each
       declared parameter spec and ``out_spec`` to a dict keyed by output
       name (a pytree of output-name strings restructures it; one of specs
       binds positionally);

    3. with no target, for a decorator with these options.

    ``in_specs`` has one ``Batched(spec)`` / ``Shared(spec)`` (or a bare
    spec pytree, meaning ``Batched``) per positional argument; its leaves
    bind to consecutive parameters.  ``batch_size=None`` takes the batch
    size from the leading axis of the first batched leaf at every call; a
    fixed ``batch_size`` is validated, and sizes a call with no batched
    argument.  Functions in one ``registry`` may call each other, whichever
    frontend defined them; decorated functions default to
    :data:`DEFAULT_NAMESPACE`, builder programs to a private namespace.

    ``backend`` is one of :data:`BACKENDS`.  The pc backend's knobs (the
    others ignore them; all are bit-exact): ``schedule`` (one of
    ``pc_vm.SCHEDULES``), ``fuse`` (superblock fusion; dead-code
    elimination runs either way), ``compact_every`` (lane compaction every
    k loop iterations) and ``collect_stats`` (per-block counters,
    ``tag_stats`` and ``scheduler_stats``).  Fault containment, pc backend
    only: ``on_fault`` (one of ``pc_vm.ON_FAULT``), ``detect_nonfinite`` and
    ``lane_step_budget`` (see :class:`pc_vm.VMConfig`).  Pipeline and
    observation, pc backend only, all bit-exact: ``verify`` (the lowered-IR
    verifier between every pass), ``trace`` (dispatch tracing into the VM's
    ring: ``True`` or a capacity; read ``fn.last_trace``) and ``pgo`` (a
    :class:`repro_torch.obs.BlockProfile` or a path to one: re-lower
    through the profile-guided passes; see :meth:`AutobatchedFunction.
    optimize`).  ``device`` is where everything runs (default: the CUDA
    card, resolved at the first call or lowering).  ``mesh`` (pc backend:
    ``None``, a rank count or a 1-D ``DeviceMesh``) shards the lanes over
    the ranks of the process group (``pc_vm.VMConfig.mesh``); it is
    resolved at the first call, where ``n`` ranks must be running.
    """
    if target is None:
        return functools.partial(
            autobatch, in_specs=in_specs, out_spec=out_spec, backend=backend,
            batch_size=batch_size, max_depth=max_depth, max_steps=max_steps,
            collect_stats=collect_stats, schedule=schedule, fuse=fuse,
            compact_every=compact_every, on_fault=on_fault,
            detect_nonfinite=detect_nonfinite, lane_step_budget=lane_step_budget,
            verify=verify, trace=trace, pgo=pgo, mesh=mesh, registry=registry,
            device=device,
        )
    obs_trace.resolve_capacity(trace)  # raises on a bad value
    if on_fault not in pc_vm.ON_FAULT:
        raise ValueError(f"on_fault must be one of {pc_vm.ON_FAULT}, got {on_fault!r}")
    if registry is not None:
        ns = registry
    elif isinstance(target, (frontend.ProgramBuilder, frontend.FunctionBuilder, ir.Function)):
        # A builder program gets a private namespace: its function names in
        # the shared one could shadow the callees of decorated functions not
        # yet traced.  Pass registry= to share one on purpose.
        ns = ast_frontend.Namespace()
    else:
        ns = DEFAULT_NAMESPACE
    opts = dict(
        backend=backend, batch_size=batch_size, max_depth=max_depth,
        max_steps=max_steps, collect_stats=collect_stats, schedule=schedule,
        fuse=fuse, compact_every=compact_every, on_fault=on_fault,
        detect_nonfinite=detect_nonfinite, lane_step_budget=lane_step_budget,
        verify=verify, trace=trace, pgo=pgo, mesh=mesh, device=device,
    )

    program: Optional[ir.Program] = None
    pinned_funcs: dict[str, ir.Function] = {}
    if isinstance(target, frontend.ProgramBuilder):
        # The builder's functions join the namespace, so they can call (and
        # be called by) restricted-Python functions.
        for func in target.functions.values():
            pinned_funcs[func.name] = ns.add(func)
        main = target.main
        main_fn = ns._built[main]
    elif isinstance(target, (frontend.FunctionBuilder, ir.Function)):
        main_fn = ns.add(target)
        main = main_fn.name
        pinned_funcs[main] = main_fn
    elif isinstance(target, ir.Program):
        program = target
        main = target.main
        main_fn = target.functions[main]
    elif callable(target):
        return _autobatch_python(target, ns, in_specs, out_spec, opts)
    else:
        raise TypeError(f"cannot autobatch {target!r}")

    params, outputs = main_fn.params, main_fn.outputs
    if in_specs is None:
        in_specs = tuple(Batched(main_fn.param_specs[p]) for p in params)
    iface_args, arg_specs = _bind_in_specs(main, params, in_specs,
                                           declared=main_fn.param_specs)
    out_treedef, out_leaves = _bind_out_spec(main, outputs, out_spec,
                                             declared=main_fn.output_specs)
    wrapped = AutobatchedFunction(
        registry=ns, main=main, program=program, iface_args=iface_args,
        arg_specs=arg_specs, out_treedef=out_treedef, out_leaves=out_leaves, **opts,
    )
    wrapped._pinned_funcs = pinned_funcs
    return wrapped


def _autobatch_python(fn, ns, in_specs, out_spec, opts) -> AutobatchedFunction:
    name = fn.__name__
    params = tuple(inspect.signature(fn).parameters)
    if in_specs is None or out_spec is None:
        raise TypeError(
            f"@autobatch over Python function {name!r} requires in_specs= "
            "and out_spec= (output types of recursive functions cannot be "
            "inferred)"
        )
    iface_args, arg_specs = _bind_in_specs(name, params, in_specs)
    for binding in iface_args:
        if len(binding.params) != 1:
            raise TypeError(
                f"{name}: restricted-Python parameters must be single-leaf "
                f"specs (argument binding {binding.params} has "
                f"{len(binding.params)} leaves); use a FunctionBuilder "
                "program for multi-leaf pytree arguments"
            )
    if _contains_dict(out_spec):
        raise TypeError(
            f"{name}: out_spec dicts with spec leaves are ambiguous "
            "(dict flatten order is sorted-key, not declaration order, so "
            "returned values would bind to sorted keys); use a tuple "
            "out_spec and restructure at the call site"
        )
    out_leaves, out_treedef = tree.tree_flatten(out_spec)
    out_leaf_specs = [_as_spec(leaf) for leaf in out_leaves]
    outputs = ast_frontend._ret_names(len(out_leaf_specs))
    param_specs = {p: arg_specs[p] for p in params}
    ns.define(param_specs=param_specs, output_specs=out_leaf_specs)(fn)
    wrapped = AutobatchedFunction(
        registry=ns, main=name, program=None, iface_args=iface_args,
        arg_specs=arg_specs, out_treedef=out_treedef, out_leaves=outputs, **opts,
    )
    wrapped._pinned = (fn, param_specs, out_leaf_specs)
    functools.update_wrapper(wrapped, fn, updated=())
    return wrapped

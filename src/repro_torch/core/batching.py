"""The public autobatching entry point (the ``vmap``-like surface).

:func:`autobatch` takes an :class:`ir.Program` or a
:class:`frontend.ProgramBuilder` and returns a callable over positional
arguments, one per program parameter::

    fib = autobatch(build_fib(), device="cpu")
    fib(torch.arange(8, dtype=torch.int32))     # -> {"out": [8] int32}

``Batched(spec)`` arguments carry a leading batch axis, whose length is
the batch size; ``Shared(spec)`` arguments have none and are broadcast to
every member.  The result is a
dict of the program's outputs, or of the names an ``out_spec`` dict maps
them to.

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

Executors are cached under ``(backend, device, batch size, input
specs, trace capacity, profile digest, fault options)``;
:meth:`AutobatchedFunction.with_options` makes a clone with other knobs
that shares the traced program, and the lowering while ``fuse``,
``verify``, the device and the profile are the same.  ``tag_stats`` and
``utilization`` cover the most recent call on every backend (``{}`` for
``reference``, which keeps no counters);
``scheduler_stats`` is the pc VM's :class:`pc_vm.SchedulerStats`.

Everything runs on ``device``: the CUDA card unless the caller passes
another device (``device="cpu"`` for the tests); with no device given and
no CUDA present, :func:`autobatch` raises.
"""
from __future__ import annotations

import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..obs import blockprof, trace as obs_trace
from . import analysis, frontend, ir, local_static, lowering, passes, pc_vm, reference

__all__ = ["Batched", "Shared", "AutobatchedFunction", "Stepper", "autobatch"]

BACKENDS = ("pc", "local", "local_eager", "reference")

#: Stack depth when ``max_depth=None`` and the program is recursive: an
#: input-dependent call depth has no static bound.
DEFAULT_MAX_DEPTH = 32


class Batched:
    """Per-member argument: the call-time tensor carries a leading batch axis."""

    shared = False

    def __init__(self, spec: ir.Spec):
        self.spec = spec


class Shared:
    """Broadcast argument: one value shared by every batch member."""

    shared = True

    def __init__(self, spec: ir.Spec):
        self.spec = spec


def trace(functions: dict[str, ir.Function], main: str) -> ir.Program:
    """The program rooted at ``main``: the functions reachable through
    ``Call`` ops, in the JAX package's discovery order (depth first, last
    callee first), so both packages number the lowered blocks alike."""
    found: dict[str, ir.Function] = {}
    worklist = [main]
    while worklist:
        name = worklist.pop()
        if name in found:
            continue
        found[name] = functions[name]
        for blk in found[name].blocks:
            for op in blk.ops:
                if isinstance(op, ir.Call) and op.callee not in found:
                    worklist.append(op.callee)
    prog = ir.Program(functions=found, main=main)
    prog.validate()
    return prog


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


_trace_program = trace  # autobatch's ``trace`` argument shadows the name


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
        (caller lane order): overflow, then the enabled detectors."""
        cfg = self.vm.config
        if cfg.on_fault != "raise":
            return
        _raise_if_overflowed(depth_exceeded.cpu().numpy(), self.batch_size,
                             cfg.max_depth, self.overflow_hint)
        if cfg.detect_nonfinite or cfg.lane_step_budget is not None:
            _raise_if_faulted(fault_code.cpu().numpy(), self.batch_size)

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
        self._ex = fn._executor(inputs, z)
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
        with, or of new ones (same shapes)."""
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
        """The halt flags (bool) and fault codes (int32) as host arrays,
        read in one transfer."""
        status = self.vm.lane_status(state).cpu().numpy()
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
        the function's calling convention at full batch width (only the
        masked rows are read).  Other lanes are untouched."""
        return self.vm.inject(state, mask, self._bind(args, "inject"))

    def depth_exceeded(self, state: dict) -> torch.Tensor:
        """``[batch]`` bool: lanes whose stacks overflowed ``max_depth``."""
        return self.vm.lane_depth_exceeded(state)

    def outputs(self, state: dict) -> dict[str, torch.Tensor]:
        """The outputs of a state, without the fault checks: final rows for
        halted lanes, whatever in-flight lanes wrote so far."""
        main = self._ex.main
        # read_top slices a packed output (pgo=) out of its group.
        return {key: self.vm.unpermute(state, self.vm.read_top(state, ir.qualify(main, name)))
                for key, name in self._fn._out_names.items()}

    def result(self, state: dict) -> dict[str, torch.Tensor]:
        """The outputs with a plain call's fault checks: under
        ``on_fault="raise"`` raise :class:`pc_vm.StackOverflow` or
        :class:`pc_vm.LaneFault`; under ``"quarantine"`` never raise."""
        self._ex.check(self.vm.lane_depth_exceeded(state), self.vm.lane_fault(state))
        return self.outputs(state)


class AutobatchedFunction:
    """A batched callable over positional arguments; made by :func:`autobatch`."""

    def __init__(
        self,
        program: ir.Program,
        bindings: tuple[ir.ArgBinding, ...],
        arg_specs: dict[str, ir.Spec],
        out_names: dict[str, str],
        *,
        backend: str,
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
        device: torch.device,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if schedule not in pc_vm.SCHEDULES:
            raise ValueError(
                f"schedule must be one of {pc_vm.SCHEDULES}, got {schedule!r}"
            )
        self.program = program
        self.main = program.main
        self.backend = backend
        self.device = device
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
        # Constructor arguments, for with_options() clones.
        self._init_args = (program, bindings, arg_specs, out_names)
        self._init_kwargs = dict(
            backend=backend, max_depth=max_depth, max_steps=max_steps,
            collect_stats=collect_stats, schedule=schedule, fuse=fuse,
            compact_every=compact_every, on_fault=on_fault,
            detect_nonfinite=detect_nonfinite, lane_step_budget=lane_step_budget,
            verify=verify, trace=trace, pgo=self.pgo, device=device,
        )
        self._bindings = bindings
        self._arg_specs = arg_specs
        self._out_names = out_names
        self._lowered: Optional[ir.LoweredProgram] = None
        self._depth_report: Optional[analysis.StackDepthReport] = None
        self._executors: dict[tuple, Any] = {}
        self._last_executor: Any = None
        self.__name__ = self.main

    @property
    def lowered(self) -> ir.LoweredProgram:
        """The stack-explicit program of the pc backend: fused (unless
        ``fuse=False``) and dead-code-eliminated, then, with ``pgo=``, put
        through the profile-guided passes (``passes.pgo_passes``), whose
        profile must come from this ``fuse`` setting.  ``verify=True``
        runs the verifier on every pass's output."""
        if self._lowered is None:
            low = lowering.lower(self.program, self.device, verify=self.verify)
            post = [*(passes.fusion_passes() if self.fuse else []),
                    passes.DeadCodeElimination()]
            if self.pgo is not None:
                post.extend(passes.pgo_passes(self.pgo))
            self._lowered = passes.PassPipeline(
                post, verify=self.verify, debug=self.verify).run(low)
        return self._lowered

    def _pgo_digest(self) -> Optional[str]:
        return None if self.pgo is None else self.pgo.digest()

    def with_options(self, **overrides: Any) -> "AutobatchedFunction":
        """A clone with some knobs changed (the :func:`autobatch` keyword
        names, e.g. ``trace=4096`` or ``schedule="lookahead"``).  It shares
        the traced program and, while ``fuse``, ``verify``, the device and
        the profile digest are unchanged, the lowering."""
        unknown = set(overrides) - set(self._init_kwargs)
        if unknown:
            raise TypeError(
                f"with_options: unknown option(s) {sorted(unknown)}; "
                f"valid names: {sorted(self._init_kwargs)}"
            )
        kw = {**self._init_kwargs, **overrides}
        clone = AutobatchedFunction(*self._init_args, **kw)
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
        if len(args) != len(self._bindings):
            raise TypeError(
                f"{self.main}() takes {len(self._bindings)} positional "
                f"argument(s), got {len(args)}"
            )
        tensors = []
        z = None
        for binding, arg in zip(self._bindings, args):
            (name,) = binding.params
            spec = self._arg_specs[name]
            x = torch.as_tensor(arg).to(device=self.device, dtype=spec.dtype)
            if binding.shared:
                if tuple(x.shape) != spec.shape:
                    raise TypeError(
                        f"{self.main}() shared argument {name!r}: expected "
                        f"shape {spec.shape}, got {tuple(x.shape)}"
                    )
            else:
                if x.dim() != len(spec.shape) + 1 or tuple(x.shape[1:]) != spec.shape:
                    raise TypeError(
                        f"{self.main}() batched argument {name!r}: expected "
                        f"a leading batch axis over {spec.shape}, got shape "
                        f"{tuple(x.shape)}"
                    )
                if z is None:
                    z = int(x.shape[0])
                elif x.shape[0] != z:
                    raise TypeError(
                        f"{self.main}() batched argument {name!r}: batch "
                        f"axis {x.shape[0]} != {z}"
                    )
            tensors.append((binding, name, x))
        if z is None:
            raise TypeError(f"{self.main}() has no Batched argument to size the batch")
        inputs = {}
        for binding, name, x in tensors:
            if binding.shared:
                x = x.expand((z,) + tuple(x.shape))
            inputs[name] = x
        return inputs, z

    def _executor(self, inputs: dict[str, torch.Tensor], z: int):
        key = (
            self.backend,
            self.device,
            z,
            tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items())),
            obs_trace.resolve_capacity(self.trace),
            self._pgo_digest(),
            self.on_fault,
            self.detect_nonfinite,
            self.lane_step_budget,
        )
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
                ),
                self.device, self._overflow_hint(),
            )
        elif self.backend in ("local", "local_eager"):
            ex = _LocalExecutor(self.program, z, self.backend == "local", self.device)
        else:
            ex = _ReferenceExecutor(self.program, z)
        self._executors[key] = ex
        return ex

    def __call__(self, *args) -> dict[str, torch.Tensor]:
        inputs, z = self._bind(args)
        ex = self._executor(inputs, z)
        self._last_executor = ex
        out = ex.run(inputs)
        return {key: out[name] for key, name in self._out_names.items()}

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


def autobatch(
    target: Any,
    *,
    in_specs: Optional[Sequence] = None,
    out_spec: Optional[dict[str, str]] = None,
    backend: str = "pc",
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
    device=None,
) -> AutobatchedFunction:
    """Autobatch an :class:`ir.Program` or a :class:`frontend.ProgramBuilder`.

    ``in_specs`` has one ``Batched(spec)`` / ``Shared(spec)`` (or a bare
    spec, meaning ``Batched``) per parameter of the main function, default
    ``Batched`` of each declared spec.  ``out_spec`` maps result keys to
    output names (default: every output under its own name).  The batch
    size is the leading axis of the batched arguments.  ``backend`` is one
    of :data:`BACKENDS`.  The pc backend's knobs (the others ignore them;
    all are bit-exact): ``schedule`` (one of ``pc_vm.SCHEDULES``), ``fuse``
    (superblock fusion; dead-code elimination runs either way),
    ``compact_every`` (lane compaction every k loop iterations) and
    ``collect_stats`` (per-block counters, ``tag_stats`` and
    ``scheduler_stats``).  Fault containment, pc backend only:
    ``on_fault`` (one of ``pc_vm.ON_FAULT``), ``detect_nonfinite`` and
    ``lane_step_budget`` (see :class:`pc_vm.VMConfig`).  Pipeline and
    observation, pc backend only, all bit-exact: ``verify`` (the lowered-IR
    verifier between every pass), ``trace`` (dispatch tracing into the VM's
    ring: ``True`` or a capacity; read ``fn.last_trace``) and ``pgo`` (a
    :class:`repro_torch.obs.BlockProfile` or a path to one: re-lower
    through the profile-guided passes; see :meth:`AutobatchedFunction.
    optimize`).  ``device`` is where everything runs (default: the CUDA
    card).  ``mesh`` is not ported and raises when set.
    """
    obs_trace.resolve_capacity(trace)  # raises on a bad value
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (lane sharding over devices) is not ported yet (ROADMAP item 14)")
    if on_fault not in pc_vm.ON_FAULT:
        raise ValueError(f"on_fault must be one of {pc_vm.ON_FAULT}, got {on_fault!r}")
    device = resolve_device(device)
    if isinstance(target, frontend.ProgramBuilder):
        program = _trace_program(target.functions, target.main)
    elif isinstance(target, ir.Program):
        program = target
    else:
        raise TypeError(f"cannot autobatch {target!r}")
    main_fn = program.functions[program.main]
    params, outputs = main_fn.params, main_fn.outputs
    if in_specs is None:
        in_specs = tuple(Batched(main_fn.param_specs[p]) for p in params)
    if len(in_specs) != len(params):
        raise TypeError(
            f"{program.main}: {len(in_specs)} in_specs for {len(params)} "
            "parameters"
        )
    bindings, arg_specs = [], {}
    for p, entry in zip(params, in_specs):
        wrap = entry if isinstance(entry, (Batched, Shared)) else Batched(entry)
        if wrap.spec != main_fn.param_specs[p]:
            raise TypeError(
                f"{program.main}: in_specs entry for parameter {p!r} is "
                f"{wrap.spec} but the program declares {main_fn.param_specs[p]}"
            )
        bindings.append(ir.ArgBinding((p,), wrap.shared))
        arg_specs[p] = wrap.spec
    out_names = {o: o for o in outputs} if out_spec is None else dict(out_spec)
    for name in out_names.values():
        if name not in outputs:
            raise TypeError(
                f"{program.main}: out_spec names unknown output {name!r} "
                f"(have {outputs})"
            )
    return AutobatchedFunction(
        program, tuple(bindings), arg_specs, out_names,
        backend=backend, max_depth=max_depth, max_steps=max_steps,
        collect_stats=collect_stats, schedule=schedule, fuse=fuse,
        compact_every=compact_every, on_fault=on_fault,
        detect_nonfinite=detect_nonfinite, lane_step_budget=lane_step_budget,
        verify=verify, trace=trace, pgo=pgo, device=device,
    )

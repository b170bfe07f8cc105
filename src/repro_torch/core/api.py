"""Legacy dict-based API of the autobatching core (deprecated shim).

.. deprecated::
    Kept as a thin compatibility shim.  New code should use the
    decorator-first, pytree-native API in :mod:`.batching`::

        from repro_torch.core.batching import autobatch, Batched, Shared

    which takes positional pytree arguments, caches executors across batch
    sizes and unifies the two frontends.

Legacy usage::

    from repro_torch.core import api, frontend

    pb = frontend.ProgramBuilder()
    ... build functions ...
    program = pb.build()

    batched = api.autobatch(program, batch_size=1024, backend="pc")
    result = batched(inputs)          # dict of [batch, ...] outputs

Backends
--------
``pc``           Program-counter autobatching (Algorithm 2) on the VM of
                 :mod:`.pc_vm`; batches across recursion depths.  The
                 paper's contribution.
``local``        Local static autobatching (Algorithm 1): host recursion,
                 each block segment replayed from a CUDA graph.
``local_eager``  Local static autobatching op by op (the paper's eager arm).
``reference``    Unbatched oracle (per-member Python recursion).

Everything runs on ``device``: the CUDA card unless the caller passes
another device (``device="cpu"``); no CUDA and no device raises.  ``mesh``
shards the pc backend's lanes over ranks (``pc_vm.VMConfig.mesh``; under a
mesh the default device is this rank's card).
"""
from __future__ import annotations

import warnings
from typing import Any, Optional

import torch

from .. import distributed
from ..device import resolve_device
from . import batching, fusion, ir, local_static, lowering, pc_vm, reference

BACKENDS = ("pc", "local", "local_eager", "reference")


class BatchedProgram:
    def __init__(
        self,
        program: ir.Program,
        batch_size: int,
        backend: str = "pc",
        max_depth: int = 32,
        max_steps: int = 1_000_000,
        collect_stats: bool = True,
        schedule: str = "earliest",
        fuse: bool = False,  # the legacy shim keeps the unfused lowering
        verify: bool = False,  # run the lowered-IR verifier between passes
        compact_every: Optional[int] = None,  # lane compaction cadence
        mesh=None,  # lane sharding: None | rank count | 1-D DeviceMesh
        device=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.program = program
        self.backend = backend
        self.batch_size = batch_size
        self.device = (resolve_device(device) if mesh is None
                       else distributed.rank_device(device))
        self.main = program.functions[program.main]
        self.last_result: Optional[pc_vm.VMResult] = None
        if backend == "pc":
            self.lowered = lowering.lower(program, self.device, verify=verify)
            if fuse:
                self.lowered = fusion.fuse(self.lowered, verify=verify)
            self.vm = pc_vm.ProgramCounterVM(
                self.lowered,
                pc_vm.VMConfig(
                    batch_size=batch_size,
                    max_depth=max_depth,
                    max_steps=max_steps,
                    collect_block_stats=collect_stats,
                    schedule=schedule,
                    compact_every=compact_every,
                    mesh=mesh,
                ),
                self.device,
            )
        elif backend in ("local", "local_eager"):
            self.batcher = local_static.LocalStaticBatcher(
                program, batch_size, jit_blocks=(backend == "local"), device=self.device
            )
        # "reference" needs no preparation.
        self._ran = False

    def __call__(self, inputs: dict[str, Any]) -> dict[str, torch.Tensor]:
        self._ran = True
        inputs = {
            p: torch.as_tensor(inputs[p]).to(device=self.device, dtype=self.main.param_specs[p].dtype)
            for p in self.main.params
        }
        if self.backend == "pc":
            # Qualify input names for the merged namespace.
            res = self.vm.run({ir.qualify(self.program.main, k): v for k, v in inputs.items()})
            self.last_result = res
            return {k.split("/", 1)[1]: v for k, v in res.outputs.items()}
        if self.backend in ("local", "local_eager"):
            # Counters of this run only, as the pc backend's last_result
            # (the batcher accumulates across runs by itself).
            self.batcher.stats = local_static.LocalStats()
            return self.batcher.run(inputs)
        return reference.run_reference_batch(self.program, inputs)

    def lower_aot(self, inputs: dict[str, Any]):
        """The AOT handle of the full batched computation
        (:class:`repro_torch.core.batching.AotLowered`; pc backend only)."""
        if self.backend != "pc":
            raise ValueError("AOT lowering requires the 'pc' backend")
        q = {
            ir.qualify(self.program.main, p): torch.as_tensor(inputs[p]).to(
                device=self.device, dtype=self.main.param_specs[p].dtype)
            for p in self.main.params
        }
        return batching.AotLowered(self.vm, q)

    @property
    def utilization(self) -> dict[str, float]:
        """Per-tag batch utilization of the last run (paper Figure 6).

        ``utilization[tag] = active_member_evals / (executions * batch_size)``.

        Identical on every backend: ``{}`` before any run; after a run,
        every tag the program executed maps to a float in ``[0, 1]``
        (``0.0`` for tags that executed with no active members).  The
        ``reference`` backend keeps no counters and always returns ``{}``.
        """
        if not self._ran:
            return {}
        if self.backend == "pc":
            if self.last_result is None:
                return {}
            return {
                tag: act / (ex * self.batch_size) if ex else 0.0
                for tag, (ex, act) in self.last_result.tag_stats.items()
            }
        if self.backend in ("local", "local_eager"):
            st = self.batcher.stats
            return {
                tag: st.tag_active.get(tag, 0) / (st.tag_execs[tag] * self.batch_size)
                if st.tag_execs.get(tag)
                else 0.0
                for tag in st.tag_execs
            }
        return {}


def autobatch(
    program: ir.Program, batch_size: int, backend: str = "pc", **kw
) -> BatchedProgram:
    """Deprecated: use :func:`repro_torch.core.batching.autobatch` instead.

    A thin shim over :class:`BatchedProgram` for callers still on the
    dict-of-names calling convention.  Two legacy differences from the
    pytree API: ``fuse`` defaults to ``False`` (the unfused lowering), and
    a stack overflow is *contained* rather than raised — overflowed members
    return invalid results, flagged per member in
    ``last_result.depth_exceeded``, while the other members stay exact.
    ``utilization`` covers the most recent call only, on every backend
    (``{}`` before any run).
    """
    warnings.warn(
        "repro_torch.core.api.autobatch is deprecated; use the pytree-native "
        "repro_torch.core.batching.autobatch instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return BatchedProgram(program, batch_size, backend=backend, **kw)

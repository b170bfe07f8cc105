"""Autobatched generation engine: the serving loop IS a program in the
paper's IR, run by the program-counter VM (a port of the JAX package's
``serve/engine.py``).

Two serving modes share the model-as-batched-primitive machinery.

**Closed-loop** (:meth:`GenerationEngine.generate`): each batch lane owns
a pre-assigned queue of requests.  The per-lane program is plain control
flow::

    for each request in my queue:          # outer while
        reset cache;                        # masked, to init_cache
        while t < prompt_len: decode(...)   # streaming prefill
        while not EOS and n < max_new:      # generation loop
            emit token; decode(...)

Lanes diverge (prompt lengths, stop times, request counts) and the VM runs
whichever block the earliest lanes wait on, masking the rest.  It runs on
any of the backends ``pc``, ``local`` and ``local_eager``.

**Open-loop** (:meth:`GenerationEngine.serve`, pc backend): each lane runs
one request at a time through a single-request program, and the VM runs
in segments (:class:`batching.Stepper`).  Between segments the host
retires finished and faulted lanes, enforces deadlines, admits arrived
requests from a bounded queue and re-initializes free lanes in place with
a masked ``inject`` (retire-and-refill).  Faulted lanes are quarantined
(``EngineConfig.on_fault``) and their requests retried with backoff.

A request with ``prompt_len == 0`` produces an empty completion, and a
lane with ``n_req == 0`` all-zero outputs; the sequential oracle
(:meth:`GenerationEngine.reference_generate`) agrees.

The model's ``decode_step`` enters the programs as one *batched*
primitive, whose KV cache leaves are ordinary VM variables (the programs
are loop-only, so the VM allocates no variable stacks for them).  Every
decode runs K4 once per layer.  Keys are threefry keys from
``mcmc/prng.py``, bit-equal to JAX's; sampling is greedy at temperature 0,
else ``prng.categorical``.

``EngineConfig.trace`` records every dispatch of the pc VM into its ring
(``pc_vm.VMConfig.trace``), for ``generate`` and ``serve`` alike; recording
never changes what is served.  With ``EngineConfig.checkpoint_dir`` the
open-loop loop snapshots its state through ``train.checkpoint`` and
``serve(resume=True)`` continues after a crash of the host loop.

Lane sharding (``EngineConfig.mesh``, pc backend): the lanes are
independent request queues, so each rank of a ``torch.distributed``
process group serves ``lanes/n`` of them on its own device
(``pc_vm.VMConfig.mesh``), and the VM's per-dispatch reduction is the only
traffic between ranks.  Every rank builds the same engine (the same model
and parameters) and makes the same calls with the same requests; results
come back whole on every rank.  In ``serve()`` every decision that reads
the clock is taken from the first rank's clock, broadcast at each read,
and the lane statuses are all-gathered each segment, so every rank admits,
retires and parks alike.  Snapshots gather the lanes to the unsharded
layout, so a snapshot resumes on any mesh size or on one device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from .. import distributed
from ..core import batching, frontend, ir, pc_vm
from ..core.frontend import spec
from ..mcmc import prng
from ..models.transformer import Model
from ..obs.metrics import MetricsRegistry
from ..train.checkpoint import Checkpointer
from ..train.fault_tolerance import StragglerPolicy

KEY = spec((2,), torch.int32)  # threefry key words (uint32 bits in JAX)
I32 = spec((), torch.int32)


@dataclass(frozen=True)
class EngineConfig:
    lanes: int  # batch width of the VM (concurrent sequences)
    max_context: int  # KV cache window
    max_prompt_len: int
    max_new_tokens: int
    requests_per_lane: int
    eos_id: int = 0
    temperature: float = 0.0  # 0: greedy
    backend: str = "pc"  # pc | local | local_eager (serve(): pc only)
    # Lane sharding (pc backend): None, a rank count or a 1-D DeviceMesh;
    # lanes must divide across it.  Each rank serves lanes/n queues.
    mesh: Any = None
    # serve(): VM loop iterations per segment between host checks.
    segment_steps: int = 64
    # Lane compaction cadence of the pc VM (pc_vm.VMConfig.compact_every);
    # requests keep their lane on every engine surface.
    compact_every: Optional[int] = None
    # Dispatch tracing of the pc VM (pc_vm.VMConfig.trace): True or a ring
    # capacity.  Read it from engine.batched.last_trace after generate(),
    # or from a Stepper's state of serve_batched.
    trace: Any = None
    # ---- fault containment and resilience (pc backend) ----
    # The VM's fault policy (pc_vm.VMConfig.on_fault): one faulted request
    # must not stop the other lanes.
    on_fault: str = "quarantine"
    # Fault a lane that writes NaN/Inf into VM state (opt-in).
    detect_nonfinite: bool = False
    # Fault a lane active in more than this many dispatches without
    # finishing its request (None: off).
    lane_step_budget: Optional[int] = None
    # Per-request deadline, arrival (or re-enqueue) to finish, checked
    # between segments; None: off.
    deadline_s: Optional[float] = None
    # Most requests arrived but not admitted; an arrival past it is
    # resolved "rejected".  None: unbounded.
    queue_capacity: Optional[int] = None
    # Faulted or timed-out requests are re-enqueued after
    # retry_backoff_s * 2**(attempt-1) until max_attempts.
    max_attempts: int = 1
    retry_backoff_s: float = 0.05
    # Host-loop crash-resume: snapshot the live VM segment state (and the
    # host's bookkeeping) through train.Checkpointer every
    # checkpoint_every_segments segments; serve(resume=True) restores the
    # newest valid snapshot and continues.  None: off.
    checkpoint_dir: Optional[str] = None
    checkpoint_every_segments: int = 8


def _cache_layout(model: Model, window: int):
    """Find each cache leaf's batch axis by differencing two batch sizes of
    the cache built on the ``meta`` device (no memory, no compute)."""
    c1 = model.init_cache(1, window, device="meta")
    c2 = model.init_cache(2, window, device="meta")
    leaves1, treedef = pytree.tree_flatten_with_path(c1)
    leaves2 = pytree.tree_leaves(c2)
    axes, member_specs = [], []
    for (path, a), b in zip(leaves1, leaves2):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diff) != 1:
            raise ValueError(
                f"ambiguous batch axis for cache leaf {pytree.keystr(path) or '<root>'}: "
                f"shapes {tuple(a.shape)} (batch=1) vs {tuple(b.shape)} (batch=2) "
                f"differ on axes {diff or 'none'}; init_cache must scale exactly "
                "one axis of every leaf with the batch size"
            )
        ax = diff[0]
        axes.append(ax)
        member_specs.append(ir.Spec(tuple(a.shape[:ax] + a.shape[ax + 1:]), a.dtype))
    return pytree.tree_structure(c1), axes, member_specs


def _cache_inits(model: Model, window: int, axes: list[int]) -> list[torch.Tensor]:
    """One lane's cache leaves as ``init_cache`` makes them (on the CPU):
    what each lane's cache is reset to before a request.  KV rings and
    SSM states start at zero, the xLSTM stabilizers ``m`` at -1e30 (the
    JAX package's engine zeroes them, so it starts xLSTM requests from
    another state than its own ``init_cache`` and oracle)."""
    leaves = pytree.tree_leaves(model.init_cache(1, window, device="cpu"))
    return [leaf.select(ax, 0) for leaf, ax in zip(leaves, axes)]


def _get(arr: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` with each index clamped into its axis, as JAX's gathers
    clamp: a lane outside the block that reads (a finished prefill's
    ``t``, a drained queue's ``req``) still computes a value under
    ``torch.func.vmap``, which the masked write then drops."""
    return arr[tuple(i.clamp(0, n - 1) for i, n in zip(idx, arr.shape))]


def _set_at(vec: torch.Tensor, i: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``vec`` with entry ``i`` replaced by ``val``, written functionally so
    that ``torch.func.vmap`` batches it (``vec.at[i].set(val)`` in JAX)."""
    return torch.where(torch.arange(vec.shape[0], device=vec.device) == i, val, vec)


def _set_at2(mat: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``mat.at[i, j].set(val)``, functionally."""
    rows = torch.arange(mat.shape[0], device=mat.device) == i
    cols = torch.arange(mat.shape[1], device=mat.device) == j
    return torch.where(rows[:, None] & cols[None, :], val, mat)


@dataclass(frozen=True)
class Request:
    """One generation request for the open-loop serving path."""

    rid: int
    prompt: np.ndarray  # [<= max_prompt_len] int32 token ids
    arrival: float = 0.0  # seconds since serve() start


#: Terminal request outcomes (Completion.status).
COMPLETION_STATUSES = ("ok", "faulted", "timeout", "rejected")


@dataclass(frozen=True)
class Completion:
    """A request resolved by :meth:`GenerationEngine.serve`, exactly once:

    * ``"ok"`` — finished; ``tokens`` holds the generation;
    * ``"faulted"`` — its lane faulted (``fault`` names the kind, one of
      ``pc_vm.FAULT_NAMES``) and no attempt was left; no tokens;
    * ``"timeout"`` — the deadline passed (queued or in flight) and no
      attempt was left; no tokens;
    * ``"rejected"`` — shed at admission: the bounded queue was full.
    """

    rid: int
    tokens: np.ndarray  # [length] int32 (empty unless status == "ok")
    lane: int  # -1 if never admitted to a lane
    arrival: float  # request arrival time
    admitted: float  # when the request was injected into a lane
    finished: float  # when the outcome was observed
    status: str = "ok"
    attempts: int = 1  # admission attempts consumed (>= 1)
    fault: Optional[str] = None  # fault kind for status == "faulted"

    @property
    def latency(self) -> float:
        """Arrival-to-finish latency (queueing and service), seconds."""
        return self.finished - self.arrival


@dataclass
class ServeStats:
    """Aggregates of one :meth:`GenerationEngine.serve` run."""

    segments: int = 0
    vm_steps: int = 0
    completions: int = 0  # every status
    generated_tokens: int = 0
    wall_time: float = 0.0
    # Mean fraction of lanes busy per segment.
    occupancy: float = 0.0
    # Outcomes by status, and the resilience counters.
    ok: int = 0
    faulted: int = 0
    timeout: int = 0
    rejected: int = 0
    retries: int = 0  # re-enqueues (not in the counts by status)
    straggler_events: int = 0  # segments flagged by the StragglerPolicy
    checkpoints: int = 0  # crash-resume snapshots written
    # Arrival-to-finish latency percentiles of the "ok" completions,
    # seconds (nan when there is none).
    p50_latency: float = float("nan")
    p99_latency: float = float("nan")
    _occ_acc: float = field(default=0.0, repr=False)


class GenerationEngine:
    """Closed- and open-loop generation over ``cfg.lanes`` lanes on the
    model's device (the card unless the model was made on the CPU)."""

    def __init__(self, model: Model, params: dict, cfg: EngineConfig,
                 metrics: Optional[MetricsRegistry] = None):
        self.model = model
        self.params = params
        self.cfg = cfg
        n = pc_vm.mesh_size(cfg.mesh)
        if cfg.lanes % n:
            raise ValueError(f"lanes={cfg.lanes} does not divide across the {n}-rank mesh")
        #: The serving loop's instruments; pass one registry to several
        #: engines to aggregate them.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.treedef, self.axes, self.member_specs = _cache_layout(model, cfg.max_context)
        self.member_inits = _cache_inits(model, cfg.max_context, self.axes)
        self.program = self._build_program()
        self.batched = batching.autobatch(
            self.program,
            out_spec={"tokens": "out", "lengths": "olens"},
            backend=cfg.backend,
            batch_size=cfg.lanes,
            max_depth=4,
            max_steps=2_000_000,
            trace=cfg.trace,
            mesh=cfg.mesh,
            device=model.device,
            **self._pc_options(),
        )
        self._serve_batched: Optional[batching.AutobatchedFunction] = None
        #: The VM's result of the most recent serve() (counters over all
        #: its segments: block_exec, tag_stats["decode"], occupancies).
        self.last_serve_result: Optional[pc_vm.VMResult] = None

    def _pc_options(self) -> dict:
        """The pc backend's fault and compaction options (the other
        backends take none)."""
        cfg = self.cfg
        if cfg.backend != "pc":
            return {}
        return dict(on_fault=cfg.on_fault, detect_nonfinite=cfg.detect_nonfinite,
                    lane_step_budget=cfg.lane_step_budget, compact_every=cfg.compact_every)

    # ------------------------------------------------------------------

    def _decode_fn(self):
        model, params = self.model, self.params
        axes, treedef = self.axes, self.treedef
        temp = self.cfg.temperature

        def decode(token, pos, key, *leaves):
            """Batched primitive: one model step for the whole batch.  The
            cache leaves arrive lane-first; they are moved back (as views)
            to the model's layout."""
            cache = pytree.tree_unflatten(
                [leaf.movedim(0, ax) for leaf, ax in zip(leaves, axes)], treedef
            )
            logits, new_cache = model.decode_step(params, cache, token, pos)
            keys = torch.func.vmap(prng.split)(key)  # [Z, 2, 2]
            if temp == 0.0:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                tok = torch.func.vmap(lambda k, lg: prng.categorical(k, lg / temp))(
                    keys[:, 1], logits).to(torch.int32)
            flat, new_def = pytree.tree_flatten(new_cache)
            if new_def != treedef:
                raise ValueError(f"decode_step returned a cache of another tree than "
                                 f"init_cache's: {new_def} vs {treedef}")
            new_leaves = [leaf.movedim(ax, 0) for leaf, ax in zip(flat, axes)]
            return (tok, keys[:, 0], *new_leaves)

        return decode

    def _build_program(self) -> ir.Program:
        cfg = self.cfg
        r, n_new = cfg.requests_per_lane, cfg.max_new_tokens
        leaf_vars = [f"cache{i}" for i in range(len(self.member_specs))]
        pb = frontend.ProgramBuilder(main="generate")
        fb = pb.function(
            "generate",
            params=["prompts", "plens", "n_req", "key"],
            outputs=["out", "olens"],
            param_specs={
                "prompts": spec((r, cfg.max_prompt_len), torch.int32),
                "plens": spec((r,), torch.int32),
                "n_req": I32, "key": KEY,
            },
            output_specs={"out": spec((r, n_new), torch.int32),
                          "olens": spec((r,), torch.int32)},
        )
        decode = self._decode_fn()

        fb.const(np.zeros((r, n_new), np.int32), out="out")
        fb.const(np.zeros((r,), np.int32), out="olens")
        fb.const(0, torch.int32, out="req")
        fb.const(0, torch.int32, out="tok")
        # ---- outer loop over this lane's request queue ----
        with fb.while_(lambda req, n_req: req < n_req, ["req", "n_req"]):
            fb.assign("plen", _get, ["plens", "req"], name="plen")
            self._emit_request_body(
                fb, decode, leaf_vars,
                read_prompt=lambda fb: fb.assign(
                    "ptok", _get, ["prompts", "req", "t"], name="read_prompt",
                ),
                emit_token=lambda fb: fb.assign(
                    "out", _set_at2, ["out", "req", "n", "tok"], name="emit",
                ),
                store_length=lambda fb: fb.assign(
                    "olens", _set_at, ["olens", "req", "n"], name="store_len",
                ),
            )
            fb.assign("req", lambda req: req + 1, ["req"])
        fb.return_()
        pb.add(fb)
        return pb.build()

    def _emit_request_body(self, fb, decode, leaf_vars, *,
                           read_prompt, emit_token, store_length) -> None:
        """Cache reset -> streaming prefill -> generation loop, reading the
        prompt length from ``plen``.  Empty prompts produce empty
        completions: with no prompt token to condition on, generation never
        starts."""
        cfg = self.cfg
        n_leaves = len(self.member_specs)
        eos, n_new = cfg.eos_id, cfg.max_new_tokens
        # reset per-request state (masked, per-lane)
        for v, init in zip(leaf_vars, self.member_inits):
            fb.prim(lambda init=init: init, (), out=v, name="reset_cache")
        fb.const(0, torch.int32, out="pos")
        fb.const(0, torch.int32, out="t")
        # ---- streaming prefill ----
        with fb.while_(lambda t, plen: t < plen, ["t", "plen"]):
            read_prompt(fb)  # writes "ptok"
            fb.prim(decode, ["ptok", "pos", "key", *leaf_vars],
                    out=("tok", "key", *leaf_vars), n_out=2 + n_leaves,
                    name="decode", batched=True, tag="decode")
            fb.assign("pos", lambda p: p + 1, ["pos"])
            fb.assign("t", lambda t: t + 1, ["t"])
        # ---- generation loop ----
        fb.const(0, torch.int32, out="n")
        fb.assign("done", lambda plen: plen == 0, ["plen"], name="empty_prompt")
        with fb.while_(lambda done, n: torch.logical_and(torch.logical_not(done), n < n_new),
                       ["done", "n"]):
            emit_token(fb)  # stores "tok" into the output buffer
            fb.assign("n", lambda n: n + 1, ["n"])
            fb.assign("done", lambda tok: tok == eos, ["tok"], name="check_eos")
            fb.prim(decode, ["tok", "pos", "key", *leaf_vars],
                    out=("tok", "key", *leaf_vars), n_out=2 + n_leaves,
                    name="decode", batched=True, tag="decode")
            fb.assign("pos", lambda p: p + 1, ["pos"])
        store_length(fb)  # records "n" as this request's length

    def _build_serve_program(self) -> ir.Program:
        """The open-loop per-lane program: one request, start to finish
        (the closed-loop body without the queue loop; the queue lives on
        the host, and a lane at the exit block waits, parked, until the
        host injects its next request)."""
        cfg = self.cfg
        leaf_vars = [f"cache{i}" for i in range(len(self.member_specs))]
        pb = frontend.ProgramBuilder(main="serve_one")
        fb = pb.function(
            "serve_one",
            params=["prompt", "plen", "key"],
            outputs=["out", "olen"],
            param_specs={"prompt": spec((cfg.max_prompt_len,), torch.int32),
                         "plen": I32, "key": KEY},
            output_specs={"out": spec((cfg.max_new_tokens,), torch.int32), "olen": I32},
        )
        decode = self._decode_fn()

        fb.const(np.zeros((cfg.max_new_tokens,), np.int32), out="out")
        fb.const(0, torch.int32, out="olen")
        fb.const(0, torch.int32, out="tok")
        self._emit_request_body(
            fb, decode, leaf_vars,
            read_prompt=lambda fb: fb.assign("ptok", _get, ["prompt", "t"], name="read_prompt"),
            emit_token=lambda fb: fb.assign("out", _set_at, ["out", "n", "tok"], name="emit"),
            store_length=lambda fb: fb.copy("n", out="olen"),
        )
        fb.return_()
        pb.add(fb)
        return pb.build()

    @property
    def serve_batched(self) -> batching.AutobatchedFunction:
        """The single-request program, autobatched on the pc VM (made at
        first use)."""
        if self._serve_batched is None:
            if self.cfg.backend != "pc":
                raise ValueError(
                    "open-loop serving needs the resumable pc backend; "
                    f"got backend={self.cfg.backend!r}"
                )
            self._serve_batched = batching.autobatch(
                self._build_serve_program(),
                out_spec={"tokens": "out", "lengths": "olen"},
                batch_size=self.cfg.lanes,
                max_depth=4,
                max_steps=2**31 - 2,  # a server's step count is unbounded
                trace=self.cfg.trace,
                mesh=self.cfg.mesh,
                device=self.model.device,
                **self._pc_options(),
            )
        return self._serve_batched

    def serve(
        self,
        requests: list[Request],
        *,
        segment_steps: Optional[int] = None,
        seed: int = 0,
        now_fn: Optional[Callable[[], float]] = None,
        on_finish: Optional[Callable[[Completion], None]] = None,
        resume: bool = False,
        straggler: Optional[StragglerPolicy] = None,
    ) -> tuple[list[Completion], ServeStats]:
        """Serve an open-loop request stream with live refill.

        Runs the single-request program in VM segments of
        ``segment_steps`` loop iterations.  Between segments the host
        reads every lane's halt flag and fault code in one transfer, then:

        1. **retires** — a halted lane's tokens become a :class:`Completion`
           (streamed through ``on_finish`` as soon as it is seen) and the
           lane returns to the free pool; a faulted lane is parked, and its
           request re-enqueued with exponential backoff while attempts
           remain (``cfg.max_attempts``), else resolved ``"faulted"``;
        2. **enforces deadlines** — a request whose ``cfg.deadline_s``
           window has passed, queued or in flight, is retried or resolved
           ``"timeout"`` (its lane is parked and freed);
        3. **admits** — requests whose arrival has passed go to free lanes
           through one masked in-place ``inject``; with
           ``cfg.queue_capacity`` set, an arrival that finds the waiting
           queue full is resolved ``"rejected"``.

        ``now_fn`` is the clock (seconds since the start; wall time by
        default, a virtual clock for deterministic tests).  Each request's
        key is ``prng_key(seed + rid)``.  Completions come back sorted by
        request id, one per request.  Segment latencies feed ``straggler``
        (``stats.straggler_events``); ``self.metrics`` gets the run's
        counters, gauges and histograms.

        With ``cfg.checkpoint_dir`` set, the live VM state and the host's
        bookkeeping (the requests done, each active lane's request and
        attempt) are snapshotted through :class:`train.checkpoint.Checkpointer`
        every ``cfg.checkpoint_every_segments`` segments and at the end.
        After a crash of the host loop, ``serve(requests, resume=True)``
        restores the newest valid snapshot, skips the requests already done
        and continues the active ones from where they were (their deadline
        windows restart at the resume).  Delivery is at least once: a
        request finished after the last snapshot is served again.  A resume
        after completion serves nothing.

        Under ``cfg.mesh`` every rank calls ``serve`` with the same
        requests; the clock is the first rank's (``now_fn``'s or the wall
        clock's reading there, broadcast at each read), so every rank takes
        the same decisions, and every rank returns every completion.
        Snapshots under a mesh gather the lanes to the unsharded layout
        (``ProgramCounterVM.gather_state``) and the first rank writes them,
        so a snapshot resumes on any mesh size or on one device; on resume
        each rank takes its lanes.
        """
        cfg = self.cfg
        z = cfg.lanes
        seg = cfg.segment_steps if segment_steps is None else int(segment_steps)
        if seg < 1:
            raise ValueError(f"segment_steps must be >= 1, got {seg}")
        if cfg.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {cfg.max_attempts}")
        for r in requests:
            if len(r.prompt) > cfg.max_prompt_len:
                raise ValueError(
                    f"request {r.rid}: prompt length {len(r.prompt)} "
                    f"exceeds max_prompt_len={cfg.max_prompt_len}"
                )
        if resume and cfg.checkpoint_dir is None:
            raise ValueError("serve(resume=True) needs cfg.checkpoint_dir")

        dev = self.model.device
        st = self.serve_batched.stepper(
            torch.zeros((z, cfg.max_prompt_len), dtype=torch.int32, device=dev),
            torch.zeros((z,), dtype=torch.int32, device=dev),
            torch.zeros((z, 2), dtype=torch.int32, device=dev),
        )
        state = st.init()
        state = st.park(state, np.ones((z,), bool))

        t0 = time.perf_counter()
        clock = now_fn if now_fn is not None else (lambda: time.perf_counter() - t0)
        mesh = st.vm.mesh
        now = clock if mesh is None else (lambda: distributed.broadcast_float(mesh, clock()))
        pol = straggler if straggler is not None else StragglerPolicy()
        completions: list[Completion] = []
        stats = ServeStats()
        m = self.metrics
        m_admissions = m.counter("serve_admissions_total", "requests injected into a lane")
        m_completions = m.counter("serve_completions_total", "terminal completions by status")
        m_retries = m.counter("serve_retries_total", "faulted/timed-out re-enqueues")
        m_tokens = m.counter("serve_generated_tokens_total", "tokens emitted by ok lanes")
        m_queue = m.gauge("serve_queue_depth", "arrived-but-not-admitted requests")
        m_lanes = m.gauge("serve_active_lanes", "lanes with a request in flight")
        m_seg = m.histogram("serve_segment_seconds", "wall time of one VM segment")
        m_latency = m.histogram("serve_request_latency_seconds",
                                "arrival->finish latency by terminal status")
        done_rids: set[int] = set()
        # Queue entries: one admission attempt of one request; "anchor" is
        # the attempt's deadline start (arrival, or re-enqueue time).
        active: dict[int, dict] = {}

        def _entry(r: Request, attempt: int = 1, not_before: Optional[float] = None) -> dict:
            anchor = r.arrival if not_before is None else not_before
            return {
                "req": r, "attempt": attempt, "not_before": anchor, "anchor": anchor,
                "deadline_at": anchor + cfg.deadline_s if cfg.deadline_s is not None else None,
                "admitted": None,
            }

        # ---- crash-resume: restore the newest snapshot ----
        ckpt = Checkpointer(cfg.checkpoint_dir, async_save=False) if cfg.checkpoint_dir else None
        ckpt_step = 0
        latest = ckpt.latest_step() if resume else None
        if latest is not None:
            ckpt_step = latest
            if mesh is None:
                state = ckpt.restore(latest, like=state)
            else:
                whole = ckpt.restore(latest, like=st.vm.gather_state(state))
                state = st.vm.shard_state(whole)
            meta = ckpt.manifest(latest).get("extra", {})
            done_rids = set(meta.get("done_rids", []))
            by_rid = {r.rid: r for r in requests}
            for lane_s, info in meta.get("active", {}).items():
                rid = int(info["rid"])
                # A rid the caller did not pass again is still served from
                # the snapshot (its tokens come from the VM).
                r = by_rid.get(rid, Request(rid=rid, prompt=np.zeros((0,), np.int32)))
                e = _entry(r, attempt=int(info.get("attempt", 1)))
                # The clock restarted with the host: the resumed attempt's
                # deadline window restarts at the resume.
                e["anchor"] = 0.0
                e["deadline_at"] = cfg.deadline_s
                e["admitted"] = 0.0
                active[int(lane_s)] = e
        in_flight = {e["req"].rid for e in active.values()}
        pend = sorted((_entry(r) for r in requests
                       if r.rid not in done_rids and r.rid not in in_flight),
                      key=lambda e: (e["not_before"], e["req"].rid))
        waiting: list[dict] = []
        free = [lane for lane in range(z) if lane not in active][::-1]

        prompts_buf = np.zeros((z, cfg.max_prompt_len), np.int32)
        plens_buf = np.zeros((z,), np.int32)
        keys_buf = np.zeros((z, 2), np.int32)
        idle_spins = 0
        max_steps_budget = st.vm.config.max_steps

        def _terminal(e: dict, status: str, lane: int, t_now: float,
                      tokens: Optional[np.ndarray] = None,
                      fault: Optional[str] = None) -> None:
            r = e["req"]
            comp = Completion(
                rid=r.rid,
                tokens=tokens if tokens is not None else np.zeros((0,), np.int32),
                lane=lane, arrival=r.arrival,
                admitted=e["admitted"] if e["admitted"] is not None else t_now,
                finished=t_now, status=status, attempts=e["attempt"], fault=fault,
            )
            completions.append(comp)
            done_rids.add(r.rid)
            setattr(stats, status, getattr(stats, status) + 1)
            m_completions.inc(status=status)
            m_latency.observe(comp.latency, status=status)
            if on_finish is not None:
                on_finish(comp)

        def _retry_or_terminal(e: dict, status: str, lane: int, t_now: float,
                               fault: Optional[str] = None) -> None:
            if e["attempt"] < cfg.max_attempts:
                stats.retries += 1
                m_retries.inc(reason=status)
                delay = cfg.retry_backoff_s * (2 ** (e["attempt"] - 1))
                pend.append(_entry(e["req"], attempt=e["attempt"] + 1,
                                   not_before=t_now + delay))
                pend.sort(key=lambda x: (x["not_before"], x["req"].rid))
            else:
                _terminal(e, status, lane, t_now, fault=fault)

        def _admit(e: dict, lane: int, mask: np.ndarray, t_now: float) -> None:
            p = np.asarray(e["req"].prompt, np.int32).reshape(-1)
            prompts_buf[lane] = 0
            prompts_buf[lane, : len(p)] = p
            plens_buf[lane] = len(p)
            keys_buf[lane] = prng.prng_key(seed + e["req"].rid).numpy()
            mask[lane] = True
            e["admitted"] = t_now
            active[lane] = e
            m_admissions.inc()

        def _save_checkpoint() -> None:
            nonlocal ckpt_step
            ckpt_step += 1
            extra = {
                "done_rids": sorted(done_rids),
                "active": {str(lane): {"rid": e["req"].rid, "attempt": e["attempt"]}
                           for lane, e in active.items()},
            }
            if mesh is None:
                ckpt.save(ckpt_step, state, extra=extra)
            else:
                # Every rank gathers; the first writes; none reads it early.
                whole = st.vm.gather_state(state)
                if dist.get_rank() == distributed.mesh_ranks(mesh)[0]:
                    ckpt.save(ckpt_step, whole, extra=extra)
                dist.barrier(group=distributed.host_group(mesh))
            stats.checkpoints += 1

        while pend or waiting or active:
            t_now = now()
            # ---- admit: arrivals -> lanes, else the bounded queue ----
            mask = np.zeros((z,), bool)
            while pend and pend[0]["not_before"] <= t_now:
                e = pend.pop(0)
                if free and not waiting:  # FIFO: queued requests go first
                    _admit(e, free.pop(), mask, t_now)
                elif cfg.queue_capacity is None or len(waiting) < cfg.queue_capacity:
                    waiting.append(e)
                else:
                    _terminal(e, "rejected", -1, t_now)
            # Queued requests whose deadline passed while waiting.
            if cfg.deadline_s is not None:
                for e in [w for w in waiting
                          if w["deadline_at"] is not None and t_now >= w["deadline_at"]]:
                    waiting.remove(e)
                    _retry_or_terminal(e, "timeout", -1, t_now)
            while waiting and free:
                _admit(waiting.pop(0), free.pop(), mask, t_now)
            if mask.any():
                state = st.inject(state, mask, torch.from_numpy(prompts_buf),
                                  torch.from_numpy(plens_buf), torch.from_numpy(keys_buf))
            if not active:
                # Every lane idle and the next arrival in the future.
                if pend and now_fn is None:
                    time.sleep(min(max(pend[0]["not_before"] - now(), 0.0), 0.01))
                elif pend:
                    idle_spins += 1
                    if idle_spins > 1_000_000:
                        raise RuntimeError(
                            "serve(): all lanes idle but the now_fn clock never "
                            f"reaches the next arrival ({pend[0]['not_before']}); "
                            "supply an advancing clock")
                continue
            idle_spins = 0

            # ---- one VM segment ----
            m_queue.set(len(waiting))
            m_lanes.set(len(active))
            t_seg = time.perf_counter()
            state = st.step(state, seg)
            # One transfer for every lane's halt flag and fault code.
            done, codes = st.lane_status(state)
            m_seg.observe(time.perf_counter() - t_seg)
            stats.segments += 1
            stats._occ_acc += len(active) / z
            if st.steps(state) >= max_steps_budget:
                raise RuntimeError(
                    f"serve(): VM step budget exhausted ({max_steps_budget} steps) "
                    f"with {len(active)} request(s) still in flight; raise the "
                    "engine program's max_steps")

            # ---- retire: finished / faulted / timed-out lanes ----
            pol.observe(stats.segments, time.perf_counter() - t_seg)
            t_now = now()
            # Fault beats done: a lane that faulted produced invalid tokens.
            faulted = [lane for lane in active if codes[lane] != pc_vm.FAULT_OK]
            finished = [lane for lane in active if done[lane] and codes[lane] == pc_vm.FAULT_OK]
            timed_out = [
                lane for lane, e in active.items()
                if lane not in faulted and lane not in finished
                and e["deadline_at"] is not None and t_now >= e["deadline_at"]
            ]
            park_mask = np.zeros((z,), bool)
            for lane in faulted:
                e = active.pop(lane)
                free.append(lane)
                park_mask[lane] = True
                _retry_or_terminal(e, "faulted", lane, t_now,
                                   fault=pc_vm.FAULT_NAMES[int(codes[lane])])
            for lane in timed_out:
                e = active.pop(lane)
                free.append(lane)
                park_mask[lane] = True
                _retry_or_terminal(e, "timeout", lane, t_now)
            if finished:
                outs = st.outputs(state)
                tokens = distributed.host_lanes(outs["tokens"]).numpy()
                lengths = distributed.host_lanes(outs["lengths"]).numpy()
                for lane in finished:
                    e = active.pop(lane)
                    toks = tokens[lane, : int(lengths[lane])].copy()
                    _terminal(e, "ok", lane, t_now, tokens=toks)
                    stats.generated_tokens += int(lengths[lane])
                    m_tokens.inc(int(lengths[lane]))
                    free.append(lane)
            if park_mask.any():
                # Idle the lanes retired with prejudice (a later inject
                # clears their fault codes).
                state = st.park(state, park_mask)

            # ---- crash-resume snapshot ----
            if (ckpt is not None and cfg.checkpoint_every_segments
                    and stats.segments % cfg.checkpoint_every_segments == 0):
                _save_checkpoint()

        if ckpt is not None:
            _save_checkpoint()  # final snapshot: a resume after completion is a no-op
        self.last_serve_result = st.vm.result(state)
        stats.vm_steps = st.steps(state)
        stats.completions = len(completions)
        stats.wall_time = time.perf_counter() - t0
        stats.occupancy = stats._occ_acc / stats.segments if stats.segments else 0.0
        stats.straggler_events = len(pol.flagged)
        stats.p50_latency = m_latency.percentile(50, status="ok")
        stats.p99_latency = m_latency.percentile(99, status="ok")
        m_queue.set(0)
        m_lanes.set(0)
        if stats.wall_time > 0:
            m.gauge("serve_tokens_per_second",
                    "generated-token throughput of the finished run",
                    ).set(stats.generated_tokens / stats.wall_time)
        completions.sort(key=lambda c: c.rid)
        return completions, stats

    # ------------------------------------------------------------------

    def generate(self, prompts: np.ndarray, prompt_lens: np.ndarray,
                 n_req: Optional[np.ndarray] = None, seed: int = 0) -> dict:
        """prompts: [lanes, R, P] i32; prompt_lens: [lanes, R] i32 (the
        whole batch on every rank under a mesh; every rank gets every
        lane's tokens)."""
        cfg = self.cfg
        z = cfg.lanes
        if n_req is None:
            n_req = np.full((z,), cfg.requests_per_lane, np.int32)
        keys = torch.stack([prng.prng_key(s) for s in range(seed, seed + z)])
        out = self.batched(
            torch.as_tensor(np.asarray(prompts, np.int32)),
            torch.as_tensor(np.asarray(prompt_lens, np.int32)),
            torch.as_tensor(np.asarray(n_req, np.int32)),
            keys,
        )
        return {
            "tokens": distributed.host_lanes(out["tokens"]).numpy(),
            "lengths": distributed.host_lanes(out["lengths"]).numpy(),
            "utilization": self.batched.utilization.get("decode", None),
        }

    def reference_generate(self, prompts, prompt_lens, n_req=None) -> dict:
        """Oracle: a plain Python loop, one lane and one request at a time,
        on the model's device, with the batched program's edge-case
        semantics (empty prompt -> empty completion; ``n_req == 0`` ->
        all-zero outputs)."""
        cfg = self.cfg
        if cfg.temperature != 0.0:
            raise ValueError("reference_generate is greedy only (temperature 0)")
        z = cfg.lanes
        dev = self.model.device
        if n_req is None:
            n_req = np.full((z,), cfg.requests_per_lane, np.int32)

        def step(cache, tok: int, pos: int):
            return self.model.decode_step(
                self.params, cache,
                torch.tensor([tok], dtype=torch.int32, device=dev),
                torch.tensor([pos], dtype=torch.int32, device=dev),
            )

        out = np.zeros((z, cfg.requests_per_lane, cfg.max_new_tokens), np.int32)
        olens = np.zeros((z, cfg.requests_per_lane), np.int32)
        for lane in range(z):
            for r in range(int(n_req[lane])):
                plen = int(prompt_lens[lane, r])
                if plen == 0:
                    continue  # empty prompt => empty completion
                cache = self.model.init_cache(1, cfg.max_context)
                for pos in range(plen):
                    logits, cache = step(cache, int(prompts[lane, r, pos]), pos)
                pos = plen
                tok = int(torch.argmax(logits[0]))
                n = 0
                done = False
                while not done and n < cfg.max_new_tokens:
                    out[lane, r, n] = tok
                    n += 1
                    done = tok == cfg.eos_id
                    logits, cache = step(cache, tok, pos)
                    pos += 1
                    tok = int(torch.argmax(logits[0]))
                olens[lane, r] = n
        return {"tokens": out, "lengths": olens}

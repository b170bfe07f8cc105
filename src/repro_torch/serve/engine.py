"""Autobatched generation engine: the serving loop IS a program in the
paper's IR, run by the program-counter VM (a port of the closed-loop part
of the JAX package's ``serve/engine.py``).

Each batch lane owns a pre-assigned queue of requests.  The per-lane
program is plain control flow::

    for each request in my queue:          # outer while
        reset cache;                        # masked zeroing
        while t < prompt_len: decode(...)   # streaming prefill
        while not EOS and n < max_new:      # generation loop
            emit token; decode(...)

Lanes diverge (prompt lengths, stop times, request counts) and the VM runs
whichever block the earliest lanes wait on, masking the rest.  A request
with ``prompt_len == 0`` produces an empty completion, and a lane with
``n_req == 0`` all-zero outputs; the sequential oracle
(:meth:`GenerationEngine.reference_generate`) agrees.

The model's ``decode_step`` enters the program as one *batched*
primitive, whose KV cache leaves are ordinary VM variables (the program is
loop-only, so the VM allocates no variable stacks for them).  Every decode
runs K4 once per layer.  Keys are threefry keys from ``mcmc/prng.py``,
bit-equal to JAX's; sampling is greedy only.

Not ported yet: open-loop ``serve()`` (it needs the VM's ``Stepper``),
fault containment, lane sharding, tracing, checkpoints and metrics
(ROADMAP queue 1, items 7, 9, 12 and 14).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core import batching, frontend, ir
from ..core.frontend import spec
from ..mcmc import prng
from ..models.transformer import Model
from .steps import check_greedy

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
    temperature: float = 0.0  # greedy only
    backend: str = "pc"  # the program-counter VM is the only backend ported


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


class GenerationEngine:
    """Closed-loop generation over ``cfg.lanes`` request queues at once, on
    the model's device (the card unless the model was made on the CPU)."""

    def __init__(self, model: Model, params: dict, cfg: EngineConfig):
        if cfg.backend != "pc":
            raise NotImplementedError(
                f"backend {cfg.backend!r}: only the program-counter VM ('pc') "
                "is ported (ROADMAP queue 1, item 8)"
            )
        check_greedy(cfg.temperature)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.treedef, self.axes, self.member_specs = _cache_layout(model, cfg.max_context)
        self.program = self._build_program()
        self.batched = batching.autobatch(
            self.program,
            out_spec={"tokens": "out", "lengths": "olens"},
            max_depth=4,
            max_steps=2_000_000,
            device=model.device,
        )

    # ------------------------------------------------------------------

    def _decode_fn(self):
        model, params = self.model, self.params
        axes, treedef = self.axes, self.treedef

        def decode(token, pos, key, *leaves):
            """Batched primitive: one model step for the whole batch.  The
            cache leaves arrive lane-first; they are moved back (as views)
            to the model's layout."""
            cache = pytree.tree_unflatten(
                [leaf.movedim(0, ax) for leaf, ax in zip(leaves, axes)], treedef
            )
            logits, new_cache = model.decode_step(params, cache, token, pos)
            new_key = torch.func.vmap(lambda k: prng.split(k)[0])(key)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            new_leaves = [leaf.movedim(ax, 0) for leaf, ax in
                          zip(pytree.tree_leaves(new_cache), axes)]
            return (tok, new_key, *new_leaves)

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
            fb.assign("plen", lambda plens, req: plens[req], ["plens", "req"], name="plen")
            self._emit_request_body(
                fb, decode, leaf_vars,
                read_prompt=lambda fb: fb.assign(
                    "ptok", lambda prompts, req, t: prompts[req, t],
                    ["prompts", "req", "t"], name="read_prompt",
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
        for v, sp in zip(leaf_vars, self.member_specs):
            zeros = torch.zeros(sp.shape, dtype=sp.dtype)
            fb.prim(lambda zeros=zeros: zeros, (), out=v, name="reset_cache")
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

    # ------------------------------------------------------------------

    def generate(self, prompts: np.ndarray, prompt_lens: np.ndarray,
                 n_req: Optional[np.ndarray] = None, seed: int = 0) -> dict:
        """prompts: [lanes, R, P] i32; prompt_lens: [lanes, R] i32."""
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
            "tokens": out["tokens"].cpu().numpy(),
            "lengths": out["lengths"].cpu().numpy(),
            "utilization": self.batched.utilization.get("decode", None),
        }

    def reference_generate(self, prompts, prompt_lens, n_req=None) -> dict:
        """Oracle: a plain Python loop, one lane and one request at a time,
        on the model's device, with the batched program's edge-case
        semantics (empty prompt -> empty completion; ``n_req == 0`` ->
        all-zero outputs)."""
        cfg = self.cfg
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

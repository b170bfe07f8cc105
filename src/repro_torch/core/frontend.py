"""Structured frontend for building autobatchable programs.

:class:`FunctionBuilder` is an explicit structured builder with ``if_`` /
``orelse`` / ``while_`` context managers and ``call`` for (possibly
recursive) calls; :class:`ProgramBuilder` collects functions into one
program.  Both produce the Fig-2 IR of :mod:`repro_torch.core.ir`.

Variables are plain strings.  ``prim`` wraps an arbitrary pure per-member
PyTorch function; the runtimes batch it with ``torch.func.vmap``, so a
primitive must be written functionally: no ``.item()``, no Python branch on
a tensor value, no in-place update of an input.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import ir


def spec(shape=(), dtype=torch.float32) -> ir.Spec:
    return ir.Spec(tuple(shape), dtype)


BOOL = spec((), torch.bool)
I32 = spec((), torch.int32)
F32 = spec((), torch.float32)


def as_constant(value, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A constant tensor with 32-bit defaults: Python ints become int32 and
    floats float32, as constants do in a JAX program without x64."""
    arr = np.asarray(value)
    if dtype is None:
        if arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        elif arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.array(arr))
    return torch.tensor(arr.tolist(), dtype=dtype)


class FunctionBuilder:
    def __init__(
        self,
        name: str,
        params: Sequence[str],
        outputs: Sequence[str],
        param_specs: dict[str, ir.Spec],
        output_specs: dict[str, ir.Spec],
    ):
        self.func = ir.Function(
            name=name,
            params=tuple(params),
            outputs=tuple(outputs),
            blocks=[ir.Block(label=f"{name}.entry")],
            param_specs=dict(param_specs),
            output_specs=dict(output_specs),
        )
        self._cur = 0
        self._tmp = itertools.count()
        self._sealed = False
        self._last_if: Optional[dict] = None

    # ------------------------------------------------------------------
    # Low-level block management
    # ------------------------------------------------------------------

    def _new_block(self, label: str = "") -> int:
        self.func.blocks.append(ir.Block(label=f"{self.func.name}.{label}"))
        return len(self.func.blocks) - 1

    def _emit(self, op: ir.Op) -> None:
        if self._sealed:
            raise RuntimeError("cannot emit after function was finalized")
        blk = self.func.blocks[self._cur]
        if blk.term is not None:
            raise RuntimeError("emitting into a terminated block")
        blk.ops.append(op)
        self._last_if = None

    def _terminate(self, term: ir.Terminator) -> None:
        blk = self.func.blocks[self._cur]
        if blk.term is None:
            blk.term = term

    def fresh(self, hint: str = "t") -> str:
        return f"%{hint}{next(self._tmp)}"

    # ------------------------------------------------------------------
    # Operations
    # ------------------------------------------------------------------

    def prim(
        self,
        fn: Callable,
        ins: Sequence[str] = (),
        out: Optional[str] = None,
        n_out: int = 1,
        name: Optional[str] = None,
        batched: bool = False,
        tag: Optional[str] = None,
    ):
        """Emit ``out(s) = fn(*ins)``; returns the output variable name(s)."""
        if n_out == 1:
            outs = (out or self.fresh(),)
        else:
            outs = tuple(
                out[i] if out else self.fresh() for i in range(n_out)
            )
        self._emit(
            ir.Prim(
                outs=outs,
                fn=fn,
                ins=tuple(ins),
                name=name or getattr(fn, "__name__", "prim"),
                batched=batched,
                tag=tag,
            )
        )
        return outs[0] if n_out == 1 else outs

    def assign(self, out: str, fn: Callable, ins: Sequence[str] = (), **kw) -> str:
        return self.prim(fn, ins, out=out, **kw)

    def const(self, value, dtype=None, out: Optional[str] = None) -> str:
        arr = as_constant(value, dtype)

        def _const():
            return arr

        return self.prim(_const, (), out=out, name=f"const[{value}]")

    def copy(self, src: str, out: Optional[str] = None) -> str:
        return self.prim(ir.identity, (src,), out=out, name="copy")

    def call(
        self,
        callee: str,
        ins: Sequence[str],
        out: Optional[str] = None,
        n_out: int = 1,
    ):
        if n_out == 1:
            outs = (out or self.fresh("r"),)
        else:
            outs = tuple(out[i] if out else self.fresh("r") for i in range(n_out))
        self._emit(ir.Call(outs=outs, callee=callee, ins=tuple(ins)))
        return outs[0] if n_out == 1 else outs

    # ------------------------------------------------------------------
    # Structured control flow
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def if_(self, cond_var: str):
        """``with b.if_(c): ...`` — optionally followed by ``with b.orelse():``."""
        branch_block = self._cur
        then_block = self._new_block("then")
        join_block = self._new_block("join")
        self.func.blocks[branch_block].term = ir.Branch(
            var=cond_var, true=then_block, false=join_block
        )
        self._cur = then_block
        yield
        self._terminate(ir.Jump(join_block))
        self._cur = join_block
        self._last_if = {
            "branch_block": branch_block,
            "join_block": join_block,
        }

    @contextlib.contextmanager
    def orelse(self):
        if self._last_if is None:
            raise RuntimeError("orelse() must immediately follow an if_()")
        info = self._last_if
        self._last_if = None
        if self.func.blocks[info["join_block"]].ops:
            raise RuntimeError("orelse() must immediately follow an if_()")
        else_block = self._new_block("else")
        bb = self.func.blocks[info["branch_block"]]
        bb.term = ir.Branch(var=bb.term.var, true=bb.term.true, false=else_block)
        self._cur = else_block
        yield
        self._terminate(ir.Jump(info["join_block"]))
        self._cur = info["join_block"]

    @contextlib.contextmanager
    def while_(self, cond_fn: Callable, cond_ins: Sequence[str]):
        """``with b.while_(lambda i, n: i < n, ['i', 'n']): ...``

        The condition primitive re-evaluates on every iteration.
        """
        cond_block = self._new_block("loop_cond")
        self._terminate(ir.Jump(cond_block))
        self._cur = cond_block
        c = self.prim(cond_fn, cond_ins, name="loop_cond")
        body_block = self._new_block("loop_body")
        join_block = self._new_block("loop_join")
        self.func.blocks[cond_block].term = ir.Branch(
            var=c, true=body_block, false=join_block
        )
        self._cur = body_block
        yield
        self._terminate(ir.Jump(cond_block))
        self._cur = join_block

    def return_(self) -> None:
        self._terminate(ir.Return())

    def build(self) -> ir.Function:
        # Seal every un-terminated block with a Return (convenience for
        # straight-line tails).
        for blk in self.func.blocks:
            if blk.term is None:
                blk.term = ir.Return()
        self._sealed = True
        return self.func


class ProgramBuilder:
    def __init__(self, main: Optional[str] = None):
        self.functions: dict[str, ir.Function] = {}
        self.main = main

    def function(
        self,
        name: str,
        params: Sequence[str],
        outputs: Sequence[str],
        param_specs: dict,
        output_specs: dict,
    ) -> FunctionBuilder:
        return FunctionBuilder(name, params, outputs, param_specs, output_specs)

    def add(self, fb: FunctionBuilder) -> None:
        func = fb.build()
        self.functions[func.name] = func
        if self.main is None:
            self.main = func.name

    def build(self) -> ir.Program:
        prog = ir.Program(functions=dict(self.functions), main=self.main)
        prog.validate()
        return prog

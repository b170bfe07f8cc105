"""Restricted-Python AST frontend (the paper's AutoGraph-style transform).

The paper implements autobatching "as a general program transformation on
Python source".  This module does that for a restricted but expressive
Python subset, producing the Fig-2 IR of :mod:`.ir` through
:class:`.frontend.FunctionBuilder`:

* statements: ``=``, ``+=`` etc., ``if``/``elif``/``else``, ``while``,
  ``return``, ``pass``;
* expressions: arbitrary pure PyTorch expressions (operators, ``torch.*``
  calls, indexing, tuples in returns), evaluated in the function's globals
  and closure, PLUS calls to other *registered* autobatchable functions
  (including recursive self-calls), which are hoisted into IR ``Call`` ops
  in ANF style;
* multiple ``return`` statements are fine; every return must yield the same
  number of values.

A constant expression (one that reads no program variable: ``steps = 0``,
``return 1``) goes through :func:`.frontend.as_constant`, so Python ints
become int32 and floats float32, as in a JAX program without x64.

Usage::

    ns = Namespace()

    @ns.define(param_specs={'n': I32}, output_specs=[I32])
    def fib(n):
        if n < 2:
            return n
        return fib(n - 1) + fib(n - 2)

    program = ns.program(main='fib')

The source is read with ``inspect.getsource``, so a function must live in a
file (or in ``linecache``); one made by ``exec`` or typed at a REPL raises
:class:`ASTFrontendError`.
"""
from __future__ import annotations

import ast
import inspect
import itertools
import textwrap
from typing import Any, Callable, Sequence

import torch

from . import frontend, ir


class ASTFrontendError(NotImplementedError):
    pass


def _ret_names(n: int) -> tuple[str, ...]:
    return ("out",) if n == 1 else tuple(f"out{i}" for i in range(n))


def _constant(value: Any) -> Any:
    """A nullary expression's value with 32-bit defaults (tensors as they are)."""
    if isinstance(value, tuple):
        return tuple(_constant(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value
    return frontend.as_constant(value)


class Namespace:
    """A registry of autobatchable functions that may call each other.

    This is the *unified* frontend namespace: it holds both restricted-Python
    functions (AST-transformed on demand) and pre-built IR functions coming
    from :class:`.frontend.FunctionBuilder`.  Either kind may call the other
    by name — ``trace()`` assembles them into one :class:`ir.Program`.
    """

    def __init__(self):
        self._specs: dict[str, tuple[dict, list]] = {}
        self._pyfns: dict[str, Callable] = {}
        self._built: dict[str, ir.Function] = {}

    def define(self, param_specs: dict, output_specs: Sequence) -> Callable:
        """Decorator registering a restricted-Python function."""

        def deco(fn: Callable) -> Callable:
            name = fn.__name__
            self._specs[name] = (dict(param_specs), list(output_specs))
            self._pyfns[name] = fn
            # Redefinition shadows: drop any IR built from a previous body.
            self._built.pop(name, None)
            return fn

        return deco

    def add(self, func) -> ir.Function:
        """Register a builder-defined function (or a raw ``ir.Function``).

        Accepts a :class:`.frontend.FunctionBuilder` (built here) or an
        already-built :class:`ir.Function`.  Registered builder functions are
        callable from restricted-Python functions and vice versa.
        """
        if isinstance(func, frontend.FunctionBuilder):
            func = func.build()
        if not isinstance(func, ir.Function):
            raise TypeError(f"expected FunctionBuilder or ir.Function, got {func!r}")
        self._built[func.name] = func
        return func

    def names(self) -> set[str]:
        return set(self._pyfns) | set(self._built)

    def __contains__(self, name: str) -> bool:
        return name in self._pyfns or name in self._built

    def trace(self, main: str, prune: bool = True) -> ir.Program:
        """Assemble the program rooted at ``main``.

        AST functions are transformed on demand; with ``prune=True`` only
        functions reachable from ``main`` through ``Call`` ops are included
        (a shared namespace may hold unrelated function families).  The
        functions are found in the JAX package's order (depth first, last
        callee first), so both packages number the lowered blocks alike.
        """
        if main not in self:
            raise ValueError(f"main function {main!r} is not registered")
        functions: dict[str, ir.Function] = {}
        worklist = [main]
        while worklist:
            name = worklist.pop()
            if name in functions:
                continue
            functions[name] = self._function(name)
            for blk in functions[name].blocks:
                for op in blk.ops:
                    if isinstance(op, ir.Call) and op.callee not in functions:
                        worklist.append(op.callee)
        if not prune:
            for name in self.names():
                functions.setdefault(name, self._function(name))
        prog = ir.Program(functions=functions, main=main)
        prog.validate()
        return prog

    def program(self, main: str) -> ir.Program:
        """Build *every* registered function (``trace(main, prune=False)``)."""
        return self.trace(main, prune=False)

    # ------------------------------------------------------------------

    def _function(self, name: str) -> ir.Function:
        if name not in self._built:
            self._built[name] = self._transform(name)
        return self._built[name]

    def _transform(self, name: str) -> ir.Function:
        fn = self._pyfns[name]
        param_specs, output_specs = self._specs[name]
        try:
            src = textwrap.dedent(inspect.getsource(fn))
        except (OSError, TypeError) as e:
            raise ASTFrontendError(
                f"{name}: cannot read the function's source ({e}); define it "
                "in a file, not with exec or at a REPL"
            ) from None
        tree = ast.parse(src)
        fdef = tree.body[0]
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            raise ASTFrontendError(f"{name}: expected a function definition")
        params = [a.arg for a in fdef.args.args]
        if set(params) != set(param_specs):
            raise ASTFrontendError(
                f"{name}: param_specs keys {sorted(param_specs)} do not match "
                f"parameters {params}"
            )
        outputs = _ret_names(len(output_specs))
        fb = frontend.FunctionBuilder(
            name,
            params,
            outputs,
            param_specs,
            dict(zip(outputs, output_specs)),
        )
        closure_ns = dict(fn.__globals__)
        if fn.__closure__:
            for cname, cell in zip(fn.__code__.co_freevars, fn.__closure__):
                closure_ns[cname] = cell.cell_contents
        conv = _Converter(self, fb, params, closure_ns, outputs)
        conv.convert_body(fdef.body)
        fb.return_()  # seal fall-through paths
        return fb.build()


class _Converter:
    def __init__(self, ns: Namespace, fb: frontend.FunctionBuilder, params,
                 closure_ns, outputs):
        self.ns = ns
        self.fb = fb
        self.closure_ns = closure_ns
        self.outputs = outputs
        # Variables that live in the IR (everything assigned or a parameter).
        self.program_vars: set[str] = set(params)
        self._tmp = itertools.count()

    # ------------------------------- statements

    def convert_body(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self.convert_stmt(stmt)

    def convert_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            if len(stmt.targets) != 1:
                raise ASTFrontendError("chained assignment not supported")
            self._assign(stmt.targets[0], stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            if not isinstance(stmt.target, ast.Name):
                raise ASTFrontendError("augmented assign target must be a name")
            binop = ast.BinOp(
                left=ast.Name(id=stmt.target.id, ctx=ast.Load()),
                op=stmt.op,
                right=stmt.value,
            )
            self._assign(ast.Name(id=stmt.target.id, ctx=ast.Store()), binop)
        elif isinstance(stmt, ast.If):
            cond = self._as_var(stmt.test, hint="cond")
            with self.fb.if_(cond):
                self.convert_body(stmt.body)
            if stmt.orelse:
                with self.fb.orelse():
                    self.convert_body(stmt.orelse)
        elif isinstance(stmt, ast.While):
            if self._contains_registered_call(stmt.test):
                raise ASTFrontendError(
                    "calls to autobatchable functions are not allowed in "
                    "while conditions; hoist them into the loop body"
                )
            free = sorted(self._free_program_vars(stmt.test))
            cond_fn = self._compile_expr(stmt.test, free, hint="while_cond")
            with self.fb.while_(cond_fn, free):
                self.convert_body(stmt.body)
        elif isinstance(stmt, ast.Return):
            self._convert_return(stmt)
        elif isinstance(stmt, ast.Pass):
            pass
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            pass  # docstring
        else:
            raise ASTFrontendError(f"unsupported statement: {ast.dump(stmt)[:80]}")

    def _assign(self, target: ast.expr, value: ast.expr) -> None:
        if isinstance(target, ast.Name):
            self._assign_names([target.id], value)
        elif isinstance(target, ast.Tuple) and all(
            isinstance(e, ast.Name) for e in target.elts
        ):
            self._assign_names([e.id for e in target.elts], value)
        else:
            raise ASTFrontendError("assignment target must be name(s)")

    def _assign_names(self, names: list[str], value: ast.expr) -> None:
        # Direct call to a registered function?
        if self._is_registered_call(value):
            args = [self._as_var(a) for a in value.args]
            self.fb.call(
                value.func.id, args,
                out=names[0] if len(names) == 1 else names,
                n_out=len(names),
            )
            self.program_vars.update(names)
            return
        if len(names) > 1:
            # Tuple-unpack of a non-call expression: evaluate then project.
            value = self._hoist_calls(value)
            free = sorted(self._free_program_vars(value))
            fn = self._compile_expr(value, free, hint="tuple")
            self.fb.prim(fn, free, out=names, n_out=len(names), name="tuple_assign")
            self.program_vars.update(names)
            return
        value = self._hoist_calls(value)
        free = sorted(self._free_program_vars(value))
        fn = self._compile_expr(value, free, hint=names[0])
        self.fb.prim(fn, free, out=names[0], name=f"={names[0]}")
        self.program_vars.add(names[0])

    def _convert_return(self, stmt: ast.Return) -> None:
        if stmt.value is None:
            raise ASTFrontendError("bare return not supported; return values")
        values = (
            list(stmt.value.elts)
            if isinstance(stmt.value, ast.Tuple)
            else [stmt.value]
        )
        if len(values) != len(self.outputs):
            raise ASTFrontendError(
                f"return arity {len(values)} != declared {len(self.outputs)}"
            )
        for out, v in zip(self.outputs, values):
            self._assign_names([out], v)
        self.fb.return_()

    # ------------------------------- expressions

    def _is_registered_call(self, e: ast.expr) -> bool:
        return (
            isinstance(e, ast.Call)
            and isinstance(e.func, ast.Name)
            and e.func.id in self.ns
        )

    def _contains_registered_call(self, e: ast.expr) -> bool:
        return any(self._is_registered_call(n) for n in ast.walk(e))

    def _hoist_calls(self, e: ast.expr) -> ast.expr:
        """ANF-convert: replace registered calls inside ``e`` with temps."""
        conv = self

        class Hoister(ast.NodeTransformer):
            def visit_Call(self, node: ast.Call):
                node = self.generic_visit(node)  # inner calls first
                if conv._is_registered_call(node):
                    args = [conv._as_var(a) for a in node.args]
                    tmp = f"_call{next(conv._tmp)}"
                    conv.fb.call(node.func.id, args, out=tmp)
                    conv.program_vars.add(tmp)
                    return ast.Name(id=tmp, ctx=ast.Load())
                return node

        return ast.fix_missing_locations(Hoister().visit(e))

    def _as_var(self, e: ast.expr, hint: str = "t") -> str:
        """Ensure ``e``'s value is available as an IR variable name."""
        e = self._hoist_calls(e)
        if isinstance(e, ast.Name) and e.id in self.program_vars:
            return e.id
        free = sorted(self._free_program_vars(e))
        fn = self._compile_expr(e, free, hint=hint)
        name = f"_{hint}{next(self._tmp)}"
        self.fb.prim(fn, free, out=name, name=hint)
        self.program_vars.add(name)
        return name

    def _free_program_vars(self, e: ast.expr) -> set[str]:
        free: set[str] = set()
        for node in ast.walk(e):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                if node.id in self.program_vars:
                    free.add(node.id)
        return free

    def _compile_expr(self, e: ast.expr, free: list[str], hint: str = "expr") -> Callable:
        lam = ast.Expression(
            body=ast.Lambda(
                args=ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg=v) for v in free],
                    vararg=None,
                    kwonlyargs=[],
                    kw_defaults=[],
                    kwarg=None,
                    defaults=[],
                ),
                body=e,
            )
        )
        ast.fix_missing_locations(lam)
        code = compile(lam, filename=f"<autobatch:{hint}>", mode="eval")
        fn = eval(code, self.closure_ns)  # noqa: S307 - trusted source
        if not free:
            expr = fn

            def fn():
                return _constant(expr())

        fn.__name__ = hint
        return fn
